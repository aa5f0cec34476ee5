"""Tests of ``captionkit_torch`` that need a CUDA card: the CUDA head
kernel against its plain version, and a small beam decode through the
kernel against the same decode on the CPU. They skip where there is no
card. This file imports no JAX, so on a machine with a card and without
JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_card.py
"""

import numpy as np
import pytest
import torch

from captionkit_torch.config import CaptionKitConfig
from captionkit_torch.decode import make_decode_fn
from captionkit_torch.kernels import head as thead
from captionkit_torch.models import get_model


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def test_kernel_matches_plain_at_paper_shape(card):
    """N = 512 images x 5 beams, H = 1024, V = 9490, bf16: idx agreement
    >= 0.999, values and lse within atol 1e-3 (fp32 sums of 1024 bf16
    products in different orders)."""
    g = torch.Generator().manual_seed(7)
    h = torch.randn((2560, 1024), generator=g).to(card, torch.bfloat16)
    w = (torch.randn((1024, 9490), generator=g) * 0.03).to(card)
    b = (torch.randn((9490,), generator=g) * 0.01).to(card)
    w_p, b_p = thead.prepad_head(w, b, compute_dtype=torch.bfloat16)
    before = thead.fused_head_topk.launches
    v1, i1, l1 = thead.fused_head_topk(h, w_p, b_p, k=5)
    torch.cuda.synchronize()
    assert thead.fused_head_topk.launches == before + 1
    v2, i2, l2 = thead.reference_head_topk(h, w_p, b_p, 5)
    assert float((i1 == i2).float().mean()) >= 0.999
    torch.testing.assert_close(v1, v2, atol=1e-3, rtol=0)
    torch.testing.assert_close(l1, l2, atol=1e-3, rtol=0)


@pytest.mark.parametrize("V,k", [(384, 5), (200, 4), (8, 8)])
def test_kernel_ties_exact(card, V, k):
    """Integer logits (exact in bf16) with duplicates inside and across
    the kernel's 128-wide vocab tiles; V = 200 ends in a partial tile."""
    rng = np.random.default_rng(V)
    N = 16
    pat = rng.integers(-2, 2, (N, V)).astype(np.float32)
    pat[0] = 1.0  # a full-row tie
    if V > 130:
        pat[1, [126, 127, 128, 129, V - 1]] = 5.0  # at a tile border
    h = torch.eye(N, dtype=torch.bfloat16, device=card)
    w = torch.from_numpy(pat).to(card, torch.bfloat16)
    b = torch.zeros((V,), device=card)
    a = thead.fused_head_topk(h, w, b, k=k)
    r = thead.reference_head_topk(h, w, b, k)
    assert torch.equal(a[1], r[1]) and torch.equal(a[0], r[0])
    assert a[1][0].tolist() == list(range(k))
    torch.testing.assert_close(a[2], r[2], atol=1e-5, rtol=0)


def test_kernel_rejects_what_it_does_not_take(card):
    h = torch.zeros((4, 16), device=card)  # fp32, not bf16
    w = torch.zeros((16, 128), device=card, dtype=torch.bfloat16)
    b = torch.zeros((128,), device=card)
    with pytest.raises(TypeError):
        thead.fused_head_topk(h, w, b, k=5)
    with pytest.raises(ValueError):  # V not a multiple of 8
        thead.fused_head_topk(h.bfloat16(), w[:, :100], b[:100], k=5)
    with pytest.raises(ValueError):  # k above the kernel's largest
        thead.fused_head_topk(h.bfloat16(), w, b, k=9)


def test_small_beam_decode_on_card_matches_cpu(card):
    """A small bf16 EditNet decoded through the kernel on the card and
    through the plain head on the CPU: the same captions for nearly every
    image (a near-tie among candidates may flip one)."""
    cfg = CaptionKitConfig().override({
        "model.vocab_size": 300, "model.emb_dim": 32,
        "model.hidden_dim": 64, "model.att_dim": 16, "model.feat_dim": 48,
        "model.num_regions": 6, "decode.beam_size": 5,
        "decode.max_decode_len": 10})
    model = get_model(cfg.model)
    rng = np.random.default_rng(0)
    B = 16
    feats = torch.from_numpy(
        rng.standard_normal((B, 6, 48)).astype(np.float32))
    ex = torch.from_numpy(rng.integers(4, 300, (B, 8)))
    ln = torch.from_numpy(rng.integers(2, 9, (B,)))
    out = {}
    for dev in ("cpu", "cuda"):
        params = model.init(0, dev)
        fn = make_decode_fn(model, cfg.decode, start_id=2, end_id=-1,
                            device=dev)
        before = thead.fused_head_topk.launches
        out[dev] = fn(params, feats, ex, ln).cpu()
        launched = thead.fused_head_topk.launches - before
        assert launched == (10 if dev == "cuda" else 0)
    rows = (out["cpu"] == out["cuda"]).all(dim=1).float().mean()
    assert float(rows) >= 0.9
