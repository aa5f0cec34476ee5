"""Tests of ``captionkit_torch`` that need a CUDA card: the CUDA head
kernel and the fused decode-cell kernels against their plain versions, and
small beam decodes through the kernels against the same decodes on the
CPU. They skip where there is no card. This file imports no JAX, so on a
machine with a card and without JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_card.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from captionkit_torch.config import CaptionKitConfig
from captionkit_torch.decode import make_decode_fn
from captionkit_torch.kernels import head as thead
from captionkit_torch.kernels import megastep
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


# -- fused decode cells (kernels/megastep.py) --------------------------------

SMALL_CELLS = {"model.vocab_size": 300, "model.emb_dim": 40,
               "model.hidden_dim": 48, "model.att_dim": 24,
               "model.feat_dim": 72, "model.num_regions": 6}
PAPER_CELLS = {}  # the config's defaults are the paper's widths


def _ulp_bf16(x):
    """One bf16 ulp of |x| (x = m 2^e, m in [0.5, 1): ulp = 2^(e-8))."""
    _, e = torch.frexp(x.abs().float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def _weights_close(a, b):
    """Attention weights within one bf16 ulp of the larger value: the
    kernel and the plain version sum the same fp32 terms in other
    orders, so a weight may round to the neighbouring bf16 value."""
    a, b = a.float(), b.float()
    bar = _ulp_bf16(torch.maximum(a.abs(), b.abs()))
    assert bool(((a - b).abs() <= bar).all()), float((a - b).abs().max())


def _cell_setup(arch, over, card, B, K=5, seed=0):
    """(pack, random fp32 state and embeddings) on the card, from an
    encoded batch of B images with K beams each."""
    cfg = CaptionKitConfig().override({**over, "model.arch": arch,
                                       "model.cell_impl": "pallas"})
    model = get_model(cfg.model)
    mc = cfg.model
    params = model.init(seed, card)
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(rng.standard_normal(
        (B, mc.num_regions, mc.feat_dim)).astype(np.float32)).to(card)
    ex = torch.from_numpy(rng.integers(4, mc.vocab_size, (B, 22))).to(card)
    ln = torch.from_numpy(rng.integers(1, 23, (B,))).to(card)
    ctx = model.beam_expand(model.encode(params, feats, ex, ln), K)
    ctx = model.prepare_topk(params, ctx, K)
    g = torch.Generator().manual_seed(seed + 1)
    N = B * K
    Hp = ctx.cell_pack.w_h.shape[0] if arch == "dcnet" else \
        ctx.cell_pack.w_ha.shape[0]
    Ep = ctx.cell_pack.w_emb.shape[0]
    st = [(torch.randn((N, Hp), generator=g) * 0.5).to(card)
          for _ in range(4)]
    emb = (torch.randn((N, Ep), generator=g) * 0.1).to(card)
    return mc, ctx.cell_pack, st, emb


@pytest.mark.parametrize("over,B", [(SMALL_CELLS, 7), (PAPER_CELLS, 512)])
def test_editnet_cell_kernels_match_plain(card, over, B):
    mc, pack, (h_att, c_att, h_lang, c_lang), emb = _cell_setup(
        "editnet", over, card, B)
    before = (megastep.att_cell.launches, megastep.lang_cell.launches)
    got = megastep.att_cell(pack, emb, h_att, c_att, h_lang)
    want = megastep.reference_att_cell(pack, emb, h_att, c_att, h_lang)
    torch.cuda.synchronize()
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, atol=1e-3, rtol=0)
    for g, w in zip(got[2:], want[2:]):
        assert g.dtype == torch.bfloat16
        _weights_close(g, w)
    vhat = megastep._grouped(want[2], pack.features)
    c_star = megastep._grouped(want[3], pack.enc_cs)
    got = megastep.lang_cell(pack, vhat, want[0], h_lang, c_lang, c_star)
    want = megastep.reference_lang_cell(pack, vhat, want[0], h_lang, c_lang,
                                        c_star)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-3, rtol=0)
    assert (megastep.att_cell.launches, megastep.lang_cell.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("over,B", [(SMALL_CELLS, 7), (PAPER_CELLS, 512)])
def test_dcnet_cell_kernels_match_plain(card, over, B):
    _, pack, (h, c, _, _), emb = _cell_setup("dcnet", over, card, B)
    got = megastep.dcnet_score(pack, h)
    want = megastep.reference_dcnet_score(pack, h)
    torch.cuda.synchronize()
    _weights_close(got, want)
    ctx = megastep._grouped(want, pack.enc_hs)
    got = megastep.dcnet_cell(pack, emb, ctx, h, c)
    want = megastep.reference_dcnet_cell(pack, emb, ctx, h, c)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-3, rtol=0)


def test_cell_wrappers_reject_what_they_do_not_take(card):
    mc, pack, (h_att, c_att, h_lang, c_lang), emb = _cell_setup(
        "editnet", SMALL_CELLS, card, 3)
    with pytest.raises(TypeError):  # bf16 state, not fp32
        megastep.att_cell(pack, emb, h_att.bfloat16(), c_att, h_lang)
    with pytest.raises(ValueError):  # not contiguous
        megastep.att_cell(pack, emb, h_att.t().contiguous().t(), c_att,
                          h_lang)
    with pytest.raises(ValueError):  # rows not a multiple of the images
        megastep.att_cell(pack, emb[:-1], h_att[:-1], c_att[:-1],
                          h_lang[:-1])
    with pytest.raises(ValueError):  # unpadded hidden width
        megastep.lang_cell(pack, torch.zeros_like(emb), h_att[:, :8],
                           h_lang, c_lang, c_att)
    _, dpack, (h, c, _, _), demb = _cell_setup("dcnet", SMALL_CELLS, card, 3)
    with pytest.raises(TypeError):  # fp32 pack weights, not bf16
        megastep.dcnet_score(dataclasses.replace(
            dpack, att_wq=dpack.att_wq.float()), h)
    with pytest.raises(ValueError):  # not contiguous
        megastep.dcnet_cell(dpack, demb, h.t().contiguous().t(), h, c)


@pytest.mark.parametrize("arch", ["editnet", "dcnet"])
def test_small_pallas_cells_decode_on_card_matches_cpu(card, arch):
    """A small bf16 model decoded with cell_impl="pallas": the fused
    kernels on the card, their plain versions on the CPU; the same
    captions for nearly every image."""
    cfg = CaptionKitConfig().override({
        **SMALL_CELLS, "model.arch": arch, "model.cell_impl": "pallas",
        "decode.beam_size": 5, "decode.max_decode_len": 10})
    model = get_model(cfg.model)
    rng = np.random.default_rng(0)
    B = 16
    feats = torch.from_numpy(
        rng.standard_normal((B, 6, 72)).astype(np.float32))
    ex = torch.from_numpy(rng.integers(4, 300, (B, 8)))
    ln = torch.from_numpy(rng.integers(2, 9, (B,)))
    wrappers = ((megastep.att_cell, megastep.lang_cell) if arch == "editnet"
                else (megastep.dcnet_score, megastep.dcnet_cell))
    out = {}
    for dev in ("cpu", "cuda"):
        params = model.init(0, dev)
        fn = make_decode_fn(model, cfg.decode, start_id=2, end_id=-1,
                            device=dev)
        before = [w.launches for w in wrappers]
        out[dev] = fn(params, feats, ex, ln).cpu()
        launched = [w.launches - b for w, b in zip(wrappers, before)]
        assert launched == [10 if dev == "cuda" else 0] * 2
    rows = (out["cpu"] == out["cuda"]).all(dim=1).float().mean()
    assert float(rows) >= 0.9
