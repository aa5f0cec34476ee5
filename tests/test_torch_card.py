"""Tests of ``captionkit_torch`` that need a CUDA card: the CUDA head
kernels (both extractions, the single sweep, the int8 head) and the fused
decode-cell kernels against their plain versions, and small beam decodes
through the kernels against the same decodes on the CPU. They skip where there is no card. This file imports no JAX, so on a
machine with a card and without JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_card.py
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from captionkit_torch.config import CaptionKitConfig
from captionkit_torch.decode import make_decode_fn
from captionkit_torch.kernels import build
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
    h = torch.zeros((4, 16), device=card)  # fp32 h against bf16 w
    w = torch.zeros((16, 128), device=card, dtype=torch.bfloat16)
    b = torch.zeros((128,), device=card)
    with pytest.raises(TypeError):
        thead.fused_head_topk(h, w, b, k=5)
    with pytest.raises(ValueError):  # V not a multiple of 8
        thead.fused_head_topk(h.bfloat16(), w[:, :100], b[:100], k=5)
    # k = 9, above the first kernels' largest (8), runs and matches the
    # plain version; above the largest instance (64) raises with the limit.
    g = torch.Generator().manual_seed(9)
    hr = torch.randn((40, 16), generator=g).to(card, torch.bfloat16)
    wr = torch.randn((16, 128), generator=g).to(card, torch.bfloat16)
    got = thead.fused_head_topk(hr, wr, b, k=9)
    want = thead.reference_head_topk(hr, wr, b, 9)
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=0)
    before = thead.fused_head_topk.launches
    with pytest.raises(ValueError, match="64"):
        thead.fused_head_topk(h.bfloat16(), w, b, k=65)
    assert thead.fused_head_topk.launches == before


def _paper_head(card, seed=7):
    """h fp32 [2560, 1024], w [1024, 9490], b [9490] on the card."""
    g = torch.Generator().manual_seed(seed)
    h = torch.randn((2560, 1024), generator=g).to(card)
    w = (torch.randn((1024, 9490), generator=g) * 0.03).to(card)
    b = (torch.randn((9490,), generator=g) * 0.01).to(card)
    return h, w, b


def _tie_case(card, V):
    """h = eye(N), w = integer patterns with duplicates inside and across
    the 128-wide tiles: logits row i is pattern row i, exact in bf16.
    V = "adversarial": the reference's duplicates that span extraction
    steps and tiles (tests/test_ops_pallas.py), V = 384."""
    if V == "adversarial":
        N, V = 8, 384
        pat = np.zeros((N, V), np.float32)
        pat[0, [7, 130, 300]] = 4.0
        pat[0, [12, 260]] = 3.0
        pat[1, [300, 5, 129, 383, 0]] = [9, 8, 7, 6, 5]
        pat[2, :] = 1.0
        pat[3, [126, 127, 128, 129, 255]] = 2.0
        pat[4, [200, 10, 210]] = [5.0, 5.0, 5.0]
        pat[5, :] = -1.0
        pat[5, [50, 150, 250]] = 0.0
        rng = np.random.default_rng(0)
        for r in (6, 7):
            pat[r] = rng.integers(-3, 3, V).astype(np.float32)
    else:
        rng = np.random.default_rng(V)
        N = 16
        pat = rng.integers(-2, 2, (N, V)).astype(np.float32)
        pat[0] = 1.0  # a full-row tie
        if V > 130:
            pat[1, [126, 127, 128, 129, V - 1]] = 5.0  # at a tile border
    return (torch.eye(N, device=card), torch.from_numpy(pat).to(card),
            torch.zeros((V,), device=card))


@pytest.mark.parametrize("V,k", [(384, 5), (200, 4), (8, 8),
                                 ("adversarial", 5), (9490, 5)])
def test_thresh_kernel_bit_equal_to_mask(card, V, k):
    """extract="thresh" gives the mask extraction's outputs bit for bit,
    on tie patterns and at paper shape."""
    if V == 9490:
        h, w, b = _paper_head(card)
        w, b = thead.prepad_head(w, b, compute_dtype=torch.bfloat16)
    else:
        h, w, b = _tie_case(card, V)
        w = w.bfloat16()
    h = h.bfloat16()
    before = thead.fused_head_topk_thresh.launches
    got = thead.fused_head_topk(h, w, b, k=k, extract="thresh")
    want = thead.fused_head_topk(h, w, b, k=k)
    torch.cuda.synchronize()
    assert thead.fused_head_topk_thresh.launches == before + 1
    assert all(torch.equal(a, r) for a, r in zip(got, want))
    if V != 9490:
        r = thead.reference_head_topk(h, w, b, k)
        assert torch.equal(got[0], r[0]) and torch.equal(got[1], r[1])


@pytest.mark.parametrize("V,k", [(384, 5), (200, 4), ("adversarial", 5),
                                 (9490, 5)])
def test_sweep_kernel_matches_plain(card, V, k):
    """The single sweep: ties exact; at paper shape idx agreement >= 0.999
    and values and lse within 1e-3 (fp32 sums in another order)."""
    if V == 9490:
        h, w, b = _paper_head(card)
        w, b = thead.prepad_head(w, b, compute_dtype=torch.bfloat16)
    else:
        h, w, b = _tie_case(card, V)
        w = w.bfloat16()
    h = h.bfloat16()
    before = thead.head_sweep_topk.launches
    v1, i1, l1 = thead.head_sweep_topk(h, w, b, k=k)
    torch.cuda.synchronize()
    assert thead.head_sweep_topk.launches == before + 1
    v2, i2, l2 = thead.reference_head_topk(h, w, b, k)
    if V == 9490:
        assert float((i1 == i2).float().mean()) >= 0.999
        torch.testing.assert_close(v1, v2, atol=1e-3, rtol=0)
        torch.testing.assert_close(l1, l2, atol=1e-3, rtol=0)
    else:
        assert torch.equal(i1, i2) and torch.equal(v1, v2)
        torch.testing.assert_close(l1, l2, atol=1e-5, rtol=0)


def _share_tie_case(card, N, V=9600, P=16):
    """h one-hot (row i selects pattern row i mod P) and integer patterns
    with ties on both sides of every boundary between the sweep's cluster
    shares on this card (``sweep_plan``): logits row i is pattern row
    i mod P, exact in bf16."""
    shares, per = thead.sweep_plan(N, V, thead.cluster_table("head_sweep", card))
    cuts = [c * per * thead.TILE_V for c in range(1, shares)]
    rng = np.random.default_rng(N)
    pat = rng.integers(-2, 2, (P, V)).astype(np.float32)
    pat[0] = 1.0
    for cut in cuts:
        pat[1, [cut - 1, cut]] = 5.0
        pat[2, [cut - 2, cut + 1]] = 6.0
        pat[3, [cut - 1, cut, 0, V - 1]] = 3.0
        pat[5, cut - 4:cut + 4] = 4.0
    for c in range(shares):
        pat[4, min(c * per * thead.TILE_V + 5, V - 1)] = 7.0
    h = np.zeros((N, P), np.float32)
    h[np.arange(N), np.arange(N) % P] = 1.0
    return (torch.from_numpy(h).to(card, torch.bfloat16),
            torch.from_numpy(pat).to(card, torch.bfloat16),
            torch.zeros((V,), device=card)), shares


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("N", [1, 33, 2561])
def test_sweep_kernel_ragged_rows_and_share_ties(card, N, k):
    """The sweep at row counts that leave a partial 64-row block: exact on
    ties across every cluster share boundary, and within the head bar at
    paper width (H = 1024, V = 9490) against the plain head."""
    (h, w, b), shares = _share_tie_case(card, N)
    assert shares >= 2
    v1, i1, l1 = thead.head_sweep_topk(h, w, b, k=k)
    v2, i2, l2 = thead.reference_head_topk(h, w, b, k)
    assert torch.equal(i1, i2) and torch.equal(v1, v2)
    torch.testing.assert_close(l1, l2, atol=1e-5, rtol=0)

    g = torch.Generator().manual_seed(N)
    h = torch.randn((N, 1024), generator=g).to(card, torch.bfloat16)
    w, b = thead.prepad_head(
        (torch.randn((1024, 9490), generator=g) * 0.03).to(card),
        (torch.randn((9490,), generator=g) * 0.01).to(card),
        compute_dtype=torch.bfloat16)
    v1, i1, l1 = thead.head_sweep_topk(h, w, b, k=k)
    v2, i2, l2 = thead.reference_head_topk(h, w, b, k)
    assert float((i1 == i2).float().mean()) >= 0.999
    torch.testing.assert_close(v1, v2, atol=1e-3, rtol=0)
    torch.testing.assert_close(l1, l2, atol=1e-3, rtol=0)


def test_sweep_kernel_rejects_a_wide_h(card):
    """H above the resident 1024 now streams h beside W and matches the
    plain head; an H the tensor maps cannot take (not a multiple of 8)
    raises, and nothing runs."""
    g = torch.Generator().manual_seed(1032)
    h = torch.randn((70, 1032), generator=g).to(card, torch.bfloat16)
    w = (torch.randn((1032, 384), generator=g) * 0.03).to(card,
                                                          torch.bfloat16)
    b = torch.zeros((384,), device=card)
    got = thead.head_sweep_topk(h, w, b, k=5)
    want = thead.reference_head_topk(h, w, b, 5)
    assert float((got[1] == want[1]).float().mean()) >= 0.999
    torch.testing.assert_close(got[0], want[0], atol=1e-3, rtol=0)
    torch.testing.assert_close(got[2], want[2], atol=1e-3, rtol=0)
    before = thead.head_sweep_topk.launches
    with pytest.raises(ValueError):
        thead.head_sweep_topk(h[:, :1028].contiguous(),
                              w[:1028].contiguous(), b, k=5)
    assert thead.head_sweep_topk.launches == before


@pytest.mark.parametrize("extract", ["mask", "thresh"])
def test_int8_kernel_bit_equal_to_plain_at_paper_shape(card, extract):
    """The int8 head's values and ids equal its plain version's bit for
    bit (the same quantization and dequantization arithmetic, exact int8
    sums); lse within 2e-4 (the reference's bar)."""
    h, w, b = _paper_head(card)
    w_q, scale, b_p = thead.quantize_head(w, b)
    before = thead.fused_head_topk_int8.launches
    v1, i1, l1 = thead.fused_head_topk_int8(h, w_q, scale, b_p, k=5,
                                            extract=extract)
    torch.cuda.synchronize()
    assert thead.fused_head_topk_int8.launches == before + 1
    v2, i2, l2 = thead.reference_head_topk_int8(h, w_q, scale, b_p, 5)
    assert torch.equal(i1, i2) and torch.equal(v1, v2)
    torch.testing.assert_close(l1, l2, atol=2e-4, rtol=0)


@pytest.mark.parametrize("V", [384, 200, "adversarial"])
def test_int8_kernel_ties_exact(card, V):
    """Tie patterns through the int8 head, and identical quantized columns
    (tests/test_head_quant.py): lowest ids first."""
    h, w, b = _tie_case(card, V)
    w_q, scale, b_p = thead.quantize_head(w, b)
    for extract in ("mask", "thresh"):
        got = thead.fused_head_topk_int8(h, w_q, scale, b_p, k=5,
                                         extract=extract)
        want = thead.reference_head_topk_int8(h, w_q, scale, b_p, 5)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    col = torch.from_numpy(rng.standard_normal((16, 1)).astype(np.float32))
    w_q, scale, b_p = thead.quantize_head(col.repeat(1, 130).to(card),
                                          torch.zeros((130,), device=card))
    _, idx, _ = thead.fused_head_topk_int8(x.to(card), w_q, scale, b_p, k=3)
    assert idx.tolist() == [[0, 1, 2]] * 8


def test_int8_kernel_rejects_what_it_does_not_take(card):
    h = torch.zeros((4, 16), device=card)
    w_q = torch.zeros((16, 128), device=card, dtype=torch.int8)
    s = torch.ones((128,), device=card)
    b = torch.zeros((128,), device=card)
    with pytest.raises(TypeError):  # bf16 h, not fp32
        thead.fused_head_topk_int8(h.bfloat16(), w_q, s, b, k=5)
    with pytest.raises(ValueError):  # V not a multiple of 16
        thead.fused_head_topk_int8(h, w_q[:, :120].contiguous(), s[:120],
                                   b[:120], k=5)
    with pytest.raises(ValueError):  # H not a multiple of 4
        thead.fused_head_topk_int8(h[:, :14].contiguous(),
                                   w_q[:14].contiguous(), s, b, k=5)
    with pytest.raises(ValueError):
        thead.fused_head_topk_int8(h, w_q, s, b, k=5, extract="sort")


def test_kernel_that_cannot_build_raises(card, monkeypatch, tmp_path):
    """A CUDA tensor never falls back to the plain version: a kernel whose
    source cannot be built raises, and nothing is counted."""
    monkeypatch.setattr(build, "CSRC", tmp_path)  # no sources there
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(thead, "_bound", {})
    h = torch.zeros((4, 16), device=card)
    w_q = torch.zeros((16, 128), device=card, dtype=torch.int8)
    s = torch.ones((128,), device=card)
    before = thead.fused_head_topk_int8.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        thead.fused_head_topk_int8(h, w_q, s, torch.zeros_like(s), k=5)
    with pytest.raises(RuntimeError, match="nvcc"):
        thead.head_sweep_topk(h.bfloat16(), w_q.bfloat16(), s, k=5)
    assert thead.fused_head_topk_int8.launches == before


@pytest.mark.parametrize("arch", ["editnet", "dcnet"])
def test_small_int8_decode_on_card_matches_cpu(card, arch):
    """A small model served with head_quant="int8" on the int8 feed: the
    int8 kernel on the card, its plain version on the CPU; the same
    captions for nearly every image (the fp32 hidden states differ in the
    last bits between the two devices, so a near-tie may flip)."""
    cfg = CaptionKitConfig().override({
        "model.vocab_size": 300, "model.emb_dim": 32, "model.arch": arch,
        "model.hidden_dim": 64, "model.att_dim": 16, "model.feat_dim": 48,
        "model.num_regions": 6, "model.head_quant": "int8",
        "decode.beam_size": 5, "decode.max_decode_len": 10,
        "decode.feed_dtype": "int8"})
    model = get_model(cfg.model)
    rng = np.random.default_rng(0)
    B = 16
    from captionkit_torch.data.featquant import quantize_for_feed

    feats = quantize_for_feed(
        rng.standard_normal((B, 6, 48)).astype(np.float32), "int8")
    ex = torch.from_numpy(rng.integers(4, 300, (B, 8)))
    ln = torch.from_numpy(rng.integers(2, 9, (B,)))
    out = {}
    for dev in ("cpu", "cuda"):
        params = model.init(0, dev)
        fn = make_decode_fn(model, cfg.decode, start_id=2, end_id=-1,
                            device=dev)
        before = thead.fused_head_topk_int8.launches
        out[dev] = fn(params, feats, ex, ln).cpu()
        launched = thead.fused_head_topk_int8.launches - before
        assert launched == (10 if dev == "cuda" else 0)
    rows = (out["cpu"] == out["cuda"]).all(dim=1).float().mean()
    assert float(rows) >= 0.9


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


@pytest.mark.parametrize("K", [1, 5])
@pytest.mark.parametrize("over", [SMALL_CELLS, PAPER_CELLS])
def test_dcnet_score_prefix_lengths_and_faults(card, over, K):
    """dcnet_score with K = 1 and 5 beams a row at attendable lengths 0, 1
    and T in turn: ω within one bf16 ulp, masked positions 0, a row with
    none attendable 1 / T; a lane's partial score left out of the sum over
    A, and the mask dropped, fail the bar. The keys are random (scale 0.5):
    the model's encoded keys barely vary across positions, so a share of
    the score left out would move every position alike."""
    _, pack, (h, _, _, _), _ = _cell_setup("dcnet", over, card, 64, K=K)
    B, T = pack.mask.shape
    lengths = torch.tensor([0, 1, T], device=card).repeat(B)[:B]
    g = torch.Generator().manual_seed(5)
    keys = (torch.randn(pack.att_keys.shape, generator=g) * 0.5).to(card)
    pack = dataclasses.replace(
        pack, att_keys=keys.to(pack.att_keys.dtype),
        mask=(torch.arange(T, device=card)[None, :]
              < lengths[:, None]).float())
    before = megastep.dcnet_score.launches
    got = megastep.dcnet_score(pack, h)
    torch.cuda.synchronize()
    assert megastep.dcnet_score.launches == before + 1
    want = megastep.reference_dcnet_score(pack, h)
    _weights_close(got, want)
    rows = pack.mask.repeat_interleave(K, dim=0) > 0
    some = rows.any(dim=1)
    assert bool((got[some][~rows[some]] == 0).all())
    assert bool((got[~some].float() == torch.tensor(
        1 / T).bfloat16().float()).all())
    for bad in (dataclasses.replace(pack, att_v=_lane_share_dropped(
            pack.att_v)), dataclasses.replace(
                pack, mask=torch.ones_like(pack.mask))):
        with pytest.raises(AssertionError):
            _weights_close(megastep.dcnet_score(bad, h), want)


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


# -- cell kernels of nn.dispatch (kernels/lstm.py, kernels/attention.py) -----

from captionkit_torch.kernels import attention as tattn  # noqa: E402
from captionkit_torch.kernels import lstm as tlstm  # noqa: E402
from captionkit_torch.kernels import wholestep as twhole  # noqa: E402
from captionkit_torch.nn.attention import AdditiveAttentionParams  # noqa: E402
from captionkit_torch.nn.cells import (  # noqa: E402
    CopyLSTMParams,
    LSTMParams,
)

# (rows, input width D, hidden H): the reference's shape classes
# (tests/test_ops_pallas.py), the greedy step's (DCNet D = E + H,
# EditNet's Copy-LSTM D = F + H) at 512 rows, and ragged ones: row counts
# one past the kernel's 64-row warpgroup and 128-row CTA tiles, D = 48 and
# 2080 (operands of 2 and 65 stages of 32: the kernel's two register
# buffers end unpaired), H = 72 and 96 (3 column blocks, an odd count).
CELL_SHAPES = [(8, 128, 128), (5, 48, 72), (130, 256, 128),
               (64, 3072, 1024), (512, 2048, 1024), (512, 3072, 1024),
               (1, 48, 64), (65, 2080, 96), (129, 48, 1024),
               (513, 2080, 1024)]


def _u(g, shape, scale, dev):
    return ((torch.rand(shape, generator=g) * 2 - 1) * scale).to(dev)


def _lstm_case(dev, N, D, H, copy, seed=0):
    g = torch.Generator().manual_seed(seed)
    s = H ** -0.5
    base = LSTMParams(wx=_u(g, (D, 4 * H), s, dev),
                      wh=_u(g, (H, 4 * H), s, dev), b=_u(g, (4 * H,), s, dev))
    params = CopyLSTMParams(base=base, wrx=_u(g, (D, H), s, dev),
                            wrh=_u(g, (H, H), s, dev),
                            wrc=_u(g, (H, H), s, dev),
                            br=_u(g, (H,), s, dev)) if copy else base
    x, h, c, cs = (torch.randn(shape, generator=g).to(dev)
                   for shape in ((N, D), (N, H), (N, H), (N, H)))
    return params, x, h, c, cs


def _cell_plain(params, x, h, c, cs, copy):
    """The kernel's plain version on the same padded pack."""
    if copy:
        return tlstm.reference_copy_lstm_cell(params, x, h, c, cs,
                                              compute_dtype=torch.bfloat16)
    return tlstm.reference_lstm_cell(params, x, h, c,
                                     compute_dtype=torch.bfloat16)


@pytest.mark.parametrize("copy", [False, True])
@pytest.mark.parametrize("N,D,H", CELL_SHAPES)
def test_lstm_kernels_match_plain(card, N, D, H, copy):
    """B5 against its plain version: h and c within 1e-3 (fp32 sums of up
    to 5120 bf16 products in another order); one launch a call."""
    params, x, h, c, cs = _lstm_case(card, N, D, H, copy)
    wrapper = tlstm.fused_copy_lstm_cell if copy else tlstm.fused_lstm_cell
    args = (params, x, h, c) + ((cs,) if copy else ())
    before = wrapper.launches
    got = wrapper(*args, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = _cell_plain(params, x, h, c, cs, copy)
    for g_, w_ in zip(got, want):
        assert tuple(g_.shape) == (N, H)
        torch.testing.assert_close(g_, w_, atol=1e-3, rtol=0)


def test_lstm_kernel_planted_faults_fail(card):
    """The bar catches a pack with its i and f gates exchanged, a
    Copy-LSTM whose c* rows of the copy gate are dropped, and the gates of
    two hidden columns crossed."""
    params, x, h, c, cs = _lstm_case(card, 64, 256, 128, copy=True)
    want = _cell_plain(params, x, h, c, cs, True)
    pack = tlstm.copy_lstm_cell_pack(params, torch.bfloat16)
    H = 128
    w4 = pack.w.reshape(pack.w.shape[0], 4, H)
    swapped = dataclasses.replace(
        pack, w=w4[:, [1, 0, 2, 3]].reshape(pack.w.shape).contiguous())
    no_copy = dataclasses.replace(pack, wr=torch.cat(
        [pack.wr[:-H], torch.zeros_like(pack.wr[-H:])]))
    # The i gates of hidden columns 2m and 2m + 1 exchanged: an epilogue
    # that reads the gates of two columns crossed.
    crossed = dataclasses.replace(pack, w=torch.cat(
        [pack.w[:, :H].reshape(-1, H // 2, 2).flip(-1).reshape(-1, H),
         pack.w[:, H:]], dim=1).contiguous())
    for bad in (swapped, no_copy, crossed):
        params.cache[("kernel_pack", torch.bfloat16)] = bad
        got = tlstm.fused_copy_lstm_cell(params, x, h, c, cs,
                                         compute_dtype=torch.bfloat16)
        err = max(float((g_ - w_).abs().max()) for g_, w_ in zip(got, want))
        assert err > 1e-3
    params.cache.clear()


def _attention_case(dev, B, N, A, V, Q, seed=4, masked=True):
    """``masked``: True for random prefix lengths 1..N, "0_1_P" for
    lengths 0, 1 and N in turn, False for no mask."""
    g = torch.Generator().manual_seed(seed)
    params = AdditiveAttentionParams(
        w_enc=_u(g, (V, A), V ** -0.5, dev), w_q=_u(g, (Q, A), Q ** -0.5, dev),
        v=_u(g, (A,), A ** -0.5, dev), b=_u(g, (A,), 0.1, dev))
    values = torch.randn((B, N, V), generator=g).to(dev, torch.bfloat16)
    keys = (torch.randn((B, N, A), generator=g) * 0.5).to(dev,
                                                          torch.bfloat16)
    query = torch.randn((B, Q), generator=g).to(dev)
    mask = None
    if masked:
        lengths = torch.randint(1, N + 1, (B,), generator=g).to(dev)
        if masked == "0_1_P":
            lengths = torch.tensor([0, 1, N], device=dev).repeat(B)[:B]
        mask = torch.arange(N, device=dev)[None, :] < lengths[:, None]
    return params, keys, values, query, mask


def _weights_bar(got, want):
    """w within one bf16 ulp of the weight's magnitude or 1e-4."""
    bar = torch.maximum(_ulp_bf16(torch.maximum(got.abs(), want.abs())),
                        torch.full_like(got, 1e-4))
    return bool(((got - want).abs() <= bar).all())


@pytest.mark.parametrize("B,N,A,V,Q,masked", [
    (8, 36, 512, 2048, 1024, True),    # visual attention shape class
    (6, 22, 64, 96, 96, True),         # SCMA shape class (unaligned)
    (4, 10, 8, 32, 16, False),         # no mask
    (512, 36, 512, 2048, 1024, False),  # EditNet's greedy visual attention
    (512, 22, 512, 1024, 1024, True),  # its SCMA / DCNet's text attention
    (512, 36, 512, 2048, 1024, "0_1_P"),  # prefix lengths 0, 1 and P
    (512, 22, 512, 1024, 1024, "0_1_P"),
    (6, 22, 64, 96, 96, "0_1_P"),
    (2560, 36, 512, 2048, 1024, False),  # the bench shape
    (3, 5, 128, 2056, 32, "0_1_P"),    # three value column groups
    (4, 7, 128, 1600, 32, "0_1_P"),    # a 576-column group: idle threads
    (16, 10, 1024, 256, 64, True),     # A past the lanes' registers
    (2, 3000, 128, 8, 32, "0_1_P"),    # many key and value stages a row
])
def test_attention_kernel_matches_plain(card, B, N, A, V, Q, masked):
    params, keys, values, query, mask = _attention_case(card, B, N, A, V, Q,
                                                        masked=masked)
    before = tattn.fused_additive_attention.launches
    ctx, w = tattn.fused_additive_attention(
        params, keys, values, query, mask, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert tattn.fused_additive_attention.launches == before + 1
    ctx_r, w_r = tattn.reference_additive_attention(
        params, keys, values, query, mask, compute_dtype=torch.bfloat16)
    assert w.dtype == torch.float32 and tuple(ctx.shape) == (B, V)
    assert _weights_bar(w, w_r), float((w - w_r).abs().max())
    torch.testing.assert_close(ctx, ctx_r, atol=1e-3, rtol=0)
    if masked:  # a masked position weighs exactly 0; none valid: 1 / N
        some = mask.any(dim=1)
        assert bool((w[some][~mask[some]] == 0).all())
        torch.testing.assert_close(w[~some], torch.full_like(w[~some], 1 / N),
                                   atol=1e-7, rtol=0)


def test_attention_kernel_planted_fault_fails(card):
    """Dropping the mask moves the weights past the bar."""
    params, keys, values, query, mask = _attention_case(card, 6, 22, 64, 96,
                                                        96)
    assert bool((~mask).any())
    _, w_r = tattn.reference_additive_attention(
        params, keys, values, query, mask, compute_dtype=torch.bfloat16)
    _, w = tattn.fused_additive_attention(params, keys, values, query, None,
                                          compute_dtype=torch.bfloat16)
    assert not _weights_bar(w, w_r)


def _lane_share_dropped(v):
    """v with columns 0..7 zeroed: lane 0's first eight score terms, one
    lane's partial of the warp's reduction over A, left out."""
    v = v.clone()
    v[0:8] = 0.0
    return v


@pytest.mark.parametrize("fault", ["lane_share_left_out",
                                   "slice_in_wrong_columns"])
@pytest.mark.parametrize("B,N,A,V,Q,masked", [
    (512, 36, 512, 2048, 1024, False), (6, 22, 64, 96, 96, "0_1_P")])
def test_attention_kernel_reduction_faults_fail(card, B, N, A, V, Q, masked,
                                                fault):
    """The bars catch the faults of the kernels' two reductions: a lane's
    partial score left out of the sum over A, and a thread's 8 context
    columns written over the next 8."""
    params, keys, values, query, mask = _attention_case(card, B, N, A, V, Q,
                                                        masked=masked)
    ctx_r, w_r = tattn.reference_additive_attention(
        params, keys, values, query, mask, compute_dtype=torch.bfloat16)
    if fault == "lane_share_left_out":
        params = dataclasses.replace(params, v=_lane_share_dropped(params.v),
                                     cache={})
    else:
        values = values.clone()
        values[..., 8:16] = values[..., 0:8]
    ctx, w = tattn.fused_additive_attention(
        params, keys, values, query, mask, compute_dtype=torch.bfloat16)
    assert not (_weights_bar(w, w_r)
                and float((ctx - ctx_r).abs().max()) <= 1e-3)


def _profiled_runs(card, group):
    """The calls whose CUDA launches a test counts: the tiled heads
    (``"heads"``: bf16 mask and thresh, int8 given its K-major weights, at
    paper shape) or the bf16 score kernels (``"scores"``: the dispatch
    attention at the masked 512 x 22 x 1024 class, dcnet_score at 320
    rows)."""
    if group == "heads":
        h, w, b = _paper_head(card)
        w_p, b_p = thead.prepad_head(w, b, compute_dtype=torch.bfloat16)
        hb = h.bfloat16()
        w_q, scale, b_q = thead.quantize_head(w, b)
        w_qt = thead.kmajor_head(w_q)
        return {"mask": lambda: thead.fused_head_topk(hb, w_p, b_p, k=5),
                "thresh": lambda: thead.fused_head_topk_thresh(
                    hb, w_p, b_p, k=5),
                "int8": lambda: thead.fused_head_topk_int8(
                    h, w_q, scale, b_q, k=5, w_qt=w_qt)}
    params, keys, values, query, mask = _attention_case(
        card, 512, 22, 512, 1024, 1024)
    _, dpack, (h, _, _, _), _ = _cell_setup("dcnet", PAPER_CELLS, card, 64)
    return {"attention": lambda: tattn.fused_additive_attention(
                params, keys, values, query, mask,
                compute_dtype=torch.bfloat16),
            "dcnet_score": lambda: megastep.dcnet_score(dpack, h)}


def _profile_launches(run, calls):
    """{CUDA kernel name: launches} of ``calls`` calls of ``run`` (after
    one unprofiled call), from one torch.profiler session."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def _kernels_a_call(group, name, calls=3):
    """{CUDA kernel name: launches} of ``calls`` calls of
    ``_profiled_runs(card, group)[name]``, profiled in a process of its
    own. On the H100 machine a torch.profiler session records every
    kernel only as the first session of its process: a later one, after
    other work, drops kernel records (PERF.md §7)."""
    root = Path(__file__).resolve().parents[1]
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(root)!r}, {str(root / 'tests')!r}]\n"
        "import torch\n"
        "import test_torch_card as t\n"
        f"run = t._profiled_runs(torch.device('cuda'), {group!r})[{name!r}]\n"
        f"print(json.dumps(t._profile_launches(run, {calls})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_score_kernels_two_launches_no_gemm_tile(card):
    """A bf16 call of fused_additive_attention is the K-split wgmma query
    product (query_kernel) and context_kernel; one of dcnet_score the
    wgmma query product (cell_kernel) and dcnet_scores_kernel: two CUDA
    launches each, and no cell_common.cuh gemm_kernel (the wmma tile is
    gone)."""
    runs = {"attention": ("query_kernel", "context_kernel"),
            "dcnet_score": ("cell_kernel", "dcnet_scores_kernel")}
    for name, (first, second) in runs.items():
        kernels = {k: n for k, n in _kernels_a_call("scores", name).items()
                   if "at::native" not in k}
        assert not any("gemm_kernel" in k for k in kernels), (name, kernels)
        assert sum(kernels.values()) == 6, (name, kernels)
        assert sum(n for k, n in kernels.items() if first in k) == 3
        assert sum(n for k, n in kernels.items() if second in k) == 3


def test_cell_kernels_reject_what_they_do_not_take(card):
    params, x, h, c, _ = _lstm_case(card, 8, 128, 128, copy=False)
    # fp32 compute runs the fp32 instance and matches its plain version.
    got = tlstm.fused_lstm_cell(params, x, h, c, compute_dtype=torch.float32)
    want = tlstm.reference_lstm_cell(params, x, h, c,
                                     compute_dtype=torch.float32)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, atol=1e-5, rtol=0)
    with pytest.raises(TypeError):  # no fp16 instance
        tlstm.fused_lstm_cell(params, x, h, c, compute_dtype=torch.float16)
    aparams, keys, values, query, mask = _attention_case(card, 4, 10, 8, 32,
                                                         16)
    with pytest.raises(ValueError):  # no grouped beam layout
        tattn.fused_additive_attention(
            aparams, keys, values, query.repeat_interleave(2, 0), mask,
            compute_dtype=torch.bfloat16)
    with pytest.raises(TypeError):  # fp32 keys
        tattn.fused_additive_attention(
            aparams, keys.float(), values, query, mask,
            compute_dtype=torch.bfloat16)


# -- the whole-step kernel (kernels/wholestep.py) ----------------------------


@pytest.mark.parametrize("over,B,k", [(SMALL_CELLS, 7, 5), (SMALL_CELLS, 3, 1),
                                      (PAPER_CELLS, 512, 5),
                                      (SMALL_CELLS, 3, 9),
                                      (SMALL_CELLS, 3, 16),
                                      (SMALL_CELLS, 3, 64),
                                      (PAPER_CELLS, 512, 10)])
def test_wholestep_kernel_matches_plain(card, over, B, k):
    """B9 against its plain version (lang cell, then the head of h_lang'
    in bf16): h and c within 1e-3, vals and lse within 1e-3, idx agreement
    >= 0.999; one launch a call."""
    mc, pack, (h_att, c_att, h_lang, c_lang), emb = _cell_setup(
        "editnet", over, card, B)
    from captionkit_torch.kernels.head import prepad_head

    g = torch.Generator().manual_seed(3)
    H, V = mc.hidden_dim, mc.vocab_size
    w, b = prepad_head((torch.randn((H, V), generator=g) * H ** -0.5).to(card),
                       (torch.randn((V,), generator=g) * 0.1).to(card),
                       compute_dtype=torch.bfloat16)
    h2, c2, vhat_raw, c_star = megastep.att_phase(pack, h_att[:, :H],
                                                  c_att[:, :H], h_lang[:, :H],
                                                  emb[:, :mc.emb_dim])
    args = (pack, vhat_raw, h2, c_star, h_lang[:, :H].contiguous(),
            c_lang[:, :H].contiguous(), w, b)
    before = twhole.fused_lang_head_topk.launches
    got = twhole.fused_lang_head_topk(*args, k=k)
    torch.cuda.synchronize()
    assert twhole.fused_lang_head_topk.launches == before + 1
    want = twhole.reference_lang_head_topk(*args, k=k)
    for g_, w_ in zip(got[:2], want[:2]):
        torch.testing.assert_close(g_, w_, atol=1e-3, rtol=0)
    assert float((got[3] == want[3]).float().mean()) >= 0.999
    torch.testing.assert_close(got[2], want[2], atol=1e-3, rtol=0)
    torch.testing.assert_close(got[4], want[4], atol=1e-3, rtol=0)


def test_wholestep_decode_launch_counts(card):
    """A small bf16 EditNet beam decode with cell_impl="wholestep": per
    step one att_cell and one whole-step launch, no lang_cell and no
    separate head; the same captions as the CPU for nearly every image."""
    cfg = CaptionKitConfig().override({
        **SMALL_CELLS, "model.cell_impl": "wholestep",
        "decode.beam_size": 5, "decode.max_decode_len": 10})
    model = get_model(cfg.model)
    rng = np.random.default_rng(0)
    B = 16
    feats = torch.from_numpy(
        rng.standard_normal((B, 6, 72)).astype(np.float32))
    ex = torch.from_numpy(rng.integers(4, 300, (B, 8)))
    ln = torch.from_numpy(rng.integers(2, 9, (B,)))
    wrappers = (megastep.att_cell, megastep.lang_cell,
                twhole.fused_lang_head_topk, thead.fused_head_topk)
    out = {}
    for dev in ("cpu", "cuda"):
        params = model.init(0, dev)
        fn = make_decode_fn(model, cfg.decode, start_id=2, end_id=-1,
                            device=dev)
        before = [w.launches for w in wrappers]
        out[dev] = fn(params, feats, ex, ln).cpu()
        launched = [w.launches - b for w, b in zip(wrappers, before)]
        assert launched == ([10, 0, 10, 0] if dev == "cuda" else [0] * 4)
    rows = (out["cpu"] == out["cuda"]).all(dim=1).float().mean()
    assert float(rows) >= 0.9


@pytest.mark.parametrize("arch", ["editnet", "dcnet"])
def test_small_greedy_decode_on_card_matches_cpu(card, arch):
    """A small bf16 greedy decode on the card and on the CPU: the same
    captions for nearly every image (a near-tie in an argmax may flip)."""
    cfg = CaptionKitConfig().override({
        **SMALL_CELLS, "model.arch": arch, "decode.method": "greedy",
        "decode.beam_size": 1, "decode.max_decode_len": 10})
    model = get_model(cfg.model)
    rng = np.random.default_rng(0)
    B = 16
    feats = torch.from_numpy(
        rng.standard_normal((B, 6, 72)).astype(np.float32))
    ex = torch.from_numpy(rng.integers(4, 300, (B, 8)))
    ln = torch.from_numpy(rng.integers(2, 9, (B,)))
    out = {}
    for dev in ("cpu", "cuda"):
        params = model.init(0, dev)
        fn = make_decode_fn(model, cfg.decode, start_id=2, end_id=-1,
                            device=dev)
        out[dev] = fn(params, feats, ex, ln).cpu()
    rows = (out["cpu"] == out["cuda"]).all(dim=1).float().mean()
    assert float(rows) >= 0.9


@pytest.mark.parametrize("config,sets", [
    ("editnet_greedy", []), ("dcnet_greedy", []),
    ("editnet_beam5", ["--set", "model.cell_impl=wholestep"])])
def test_cli_serves_on_card(card, config, sets, tmp_path, monkeypatch,
                            capsys):
    """``python -m captionkit_torch.cli serve --config <config> --synthetic
    --batch 512`` at paper width on the card answers every request."""
    import io
    import json
    import sys

    from captionkit_torch import cli

    rng = np.random.default_rng(0)
    lines = []
    for i in range(3):
        path = tmp_path / f"f{i}.npy"
        np.save(path, rng.standard_normal((36, 2048)).astype(np.float32))
        lines.append(json.dumps({"id": i, "caption": "a dog on a bench",
                                 "features": str(path)}))
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(lines) + "\n"))
    before = twhole.fused_lang_head_topk.launches
    assert cli.main(["serve", "--config", config, "--synthetic", "--batch",
                     "512", *sets]) == 0
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert out[0]["ready"] is True and out[0]["batch"] == 512
    assert [r["id"] for r in out[1:]] == [0, 1, 2]
    assert all(isinstance(r["caption"], str) for r in out[1:])
    launched = twhole.fused_lang_head_topk.launches - before
    assert (launched > 0) == (config == "editnet_beam5")


# -- any k, fp32 compute, wide heads, the sm90 lang cell ----------------------

KS = (1, 9, 16, 32, 64)
F32_CELLS = {"model.compute_dtype": "float32"}


def _float_head(kernel, h, w, b, k):
    if kernel == "mask":
        return thead.fused_head_topk(h, w, b, k=k)
    if kernel == "thresh":
        return thead.fused_head_topk_thresh(h, w, b, k=k)
    return thead.head_sweep_topk(h, w, b, k=k)


def _head_pair(kernel, h, w, b, k, dt=torch.bfloat16):
    """(kernel, plain) results of one head on the same inputs; float heads
    take h and w in dt, the int8 head fp32 h and quantize_head's w."""
    if kernel == "int8":
        w_q, scale, b_p = thead.quantize_head(w, b)
        return (thead.fused_head_topk_int8(h, w_q, scale, b_p, k=k),
                thead.reference_head_topk_int8(h, w_q, scale, b_p, k))
    h, w = h.to(dt), w.to(dt)
    return _float_head(kernel, h, w, b, k), thead.reference_head_topk(h, w,
                                                                      b, k)


def _head_bar(got, want, kernel, atol=1e-3):
    if kernel == "int8":
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        torch.testing.assert_close(got[2], want[2], atol=2e-4, rtol=0)
        return
    assert float((got[1] == want[1]).float().mean()) >= 0.999
    torch.testing.assert_close(got[0], want[0], atol=atol, rtol=0)
    torch.testing.assert_close(got[2], want[2], atol=atol, rtol=0)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kernel", ["mask", "thresh", "sweep", "int8"])
def test_head_kernels_take_any_k(card, kernel, k):
    """Every head kernel at k up to the largest instance: exact on integer
    ties inside and across the 128-wide tiles (and, for the sweep, across
    its cluster shares), and within its bar at paper shape."""
    h, w, b = _tie_case(card, "adversarial")
    got, want = _head_pair(kernel, h, w, b, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if kernel == "sweep":
        (hs, ws, bs), _ = _share_tie_case(card, 65)
        got = thead.head_sweep_topk(hs, ws, bs, k=k)
        want = thead.reference_head_topk(hs, ws, bs, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    h, w, b = _paper_head(card)
    w_p, b_p = thead.prepad_head(w, b, compute_dtype=torch.float32)
    got, want = _head_pair(kernel, h, w_p if kernel != "int8" else w,
                           b_p if kernel != "int8" else b, k)
    assert tuple(got[0].shape) == (h.shape[0], k)
    _head_bar(got, want, kernel)


def test_k_above_the_largest_instance_raises(card):
    """k = 65 raises with the limit named in every head wrapper and the
    whole-step kernel, and nothing is counted."""
    h, w, b = _tie_case(card, 384)
    w_q, scale, b_p = thead.quantize_head(w, b)
    calls = [
        (thead.fused_head_topk, lambda: thead.fused_head_topk(
            h.bfloat16(), w.bfloat16(), b, k=65)),
        (thead.head_sweep_topk, lambda: thead.head_sweep_topk(
            h.bfloat16(), w.bfloat16(), b, k=65)),
        (thead.fused_head_topk_int8, lambda: thead.fused_head_topk_int8(
            h, w_q, scale, b_p, k=65)),
    ]
    for wrapper, call in calls:
        before = wrapper.launches
        with pytest.raises(ValueError, match="64"):
            call()
        assert wrapper.launches == before
    assert thead.kmax_for(9) == 16 and thead.kmax_for(64) == 64


@pytest.mark.parametrize("kernel", ["mask", "sweep", "int8"])
def test_ties_to_the_higher_id_fail_at_k16(card, kernel):
    """A planted fault: the kernel run on the reversed vocab (ties broken
    to the higher id once the ids are mapped back) must fail the exact bar
    on the tie patterns at k = 16."""
    h, w, b = _tie_case(card, "adversarial")
    V = w.shape[1]
    got, _ = _head_pair(kernel, h, w.flip(1).contiguous(), b.flip(0), 16)
    _, want = _head_pair(kernel, h, w, b, 16)
    idx = (V - 1) - got[1]
    assert not torch.equal(idx, want[1])


@pytest.mark.parametrize("kernel", ["mask", "thresh", "sweep"])
def test_fp32_heads_match_plain(card, kernel):
    """compute_dtype="float32": fp32 h and w through each float head's fp32
    instance (fp32 products, not TF32) within 1e-5 of the plain version at
    paper shape, idx agreement >= 0.999, ties exact at k = 16; an operand
    rounded to bf16 (a planted fault) fails the 1e-5 bar."""
    assert not torch.backends.cuda.matmul.allow_tf32
    h, w, b = _paper_head(card)
    w_p, b_p = thead.prepad_head(w, b, compute_dtype=torch.float32)
    got, want = _head_pair(kernel, h, w_p, b_p, 5, torch.float32)
    _head_bar(got, want, kernel, atol=1e-5)
    bad = _float_head(kernel, h.bfloat16().float(), w_p, b_p, 5)
    assert float((bad[2] - want[2]).abs().max()) > 1e-5
    h, w, b = _tie_case(card, "adversarial")
    got, want = _head_pair(kernel, h, w, b, 16, torch.float32)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("k", [5, 16])
@pytest.mark.parametrize("H", [2048, 4096])
@pytest.mark.parametrize("kernel", ["sweep", "int8", "mask", "thresh"])
def test_wide_heads_match_plain(card, kernel, H, k):
    """The sweep and the tiled bf16 heads (mask, thresh: h streamed beside
    W above H = 1024) and the int8 head (its quantized rows streamed
    beside w_qt) at H = 2048 and 4096, paper vocab: within their bars;
    thresh bit-equal to mask. A float head that skipped h's second 64-wide
    chunk (a planted fault) fails the head bar."""
    g = torch.Generator().manual_seed(H + k)
    N, V = 2560, 9490
    h = torch.randn((N, H), generator=g).to(card)
    w = (torch.randn((H, V), generator=g) * H ** -0.5).to(card)
    b = (torch.randn((V,), generator=g) * 0.01).to(card)
    if kernel != "int8":
        w, b = thead.prepad_head(w, b, compute_dtype=torch.bfloat16)
    got, want = _head_pair(kernel, h, w, b, k)
    _head_bar(got, want, kernel)
    if kernel == "thresh":
        mask = _float_head("mask", h.bfloat16(), w, b, k)
        assert all(torch.equal(x, y) for x, y in zip(got, mask))
    if kernel != "int8":
        hs = h.bfloat16().clone()
        hs[:, 64:128] = 0
        bad = _float_head(kernel, hs, w, b, k)
        assert float((bad[2] - want[2]).abs().max()) > 1e-3


def _wide_tie_case(card, N, H, V=9600, P=16):
    """The float tie patterns of ``_tiled_tie_case`` at a wide H: h is
    one-hot in its last P columns (row i selects pattern row i mod P),
    the patterns sit in W's last P rows and every other row of W is
    random, met by h's zeros; ties on both sides of every cluster share
    boundary of the streamed-h plan. Returns (h, w, b, shares)."""
    shares, per = thead.sweep_plan(
        N, V, thead.cluster_table("head_topk", card, wide=True))
    cuts = [c * per * thead.TILE_V for c in range(1, shares)]
    rng = np.random.default_rng(N + H)
    pat = rng.integers(-2, 2, (P, V)).astype(np.float32)
    pat[0] = 1.0
    for cut in cuts:
        pat[1, [cut - 1, cut]] = 5.0
        pat[2, [cut - 2, cut + 1]] = 6.0
        pat[3, [cut - 1, cut, 0, V - 1]] = 3.0
        pat[5, cut - 4:cut + 4] = 4.0
    for c in range(shares):
        pat[4, min(c * per * thead.TILE_V + 5, V - 1)] = 7.0
    for t in range(V // thead.TILE_V):
        pat[6, t * thead.TILE_V + 3] = 9.0
        pat[7, t * thead.TILE_V + 126:t * thead.TILE_V + 130] = 2.0
    w = rng.integers(-3, 3, (H, V)).astype(np.float32)
    w[H - P:] = pat
    h = np.zeros((N, H), np.float32)
    h[np.arange(N), H - P + np.arange(N) % P] = 1.0
    return (torch.from_numpy(h).to(card, torch.bfloat16),
            torch.from_numpy(w).to(card, torch.bfloat16),
            torch.zeros((V,), device=card), shares)


@pytest.mark.parametrize("k", [1, 5, 16])
@pytest.mark.parametrize("H", [2048, 4096])
def test_wide_tiled_heads_exact_on_share_ties(card, H, k):
    """mask and thresh at H = 2048 and 4096 (h streamed) on exact ties at
    every cluster share boundary of the wide plan, in every tile and
    across whole rows, N = 2560: values and ids equal to the plain
    version's, thresh bit-equal to mask."""
    h, w, b, shares = _wide_tie_case(card, 2560, H)
    assert shares >= 2
    want = thead.reference_head_topk(h, w, b, k)
    mask = thead.fused_head_topk(h, w, b, k=k)
    thresh = thead.fused_head_topk_thresh(h, w, b, k=k)
    assert _exact(mask, want, "mask")
    assert all(torch.equal(x, y) for x, y in zip(thresh, mask))


# -- the tiled heads on csrc/head_sm90.cuh (mask, thresh, int8) ---------------


def _tiled(kernel, h, w, b, k, fault=0):
    """One tiled head through its kernel (``fault`` 1: a tile skipped on a
    max equal to the running k-th value, a planted fault); the int8 head
    takes fp32 h and the float head's w, quantized here."""
    if kernel == "int8":
        w_q, scale, b_p = thead.quantize_head(w.float(), b)
        return thead._launch_int8(h.float(), w_q, scale, b_p, k, "mask",
                                  thead.kmajor_head(w_q), fault)
    wrapper = (thead.fused_head_topk if kernel == "mask"
               else thead.fused_head_topk_thresh)
    return thead._launch_tiled(h.bfloat16(), w.bfloat16(), b, k, kernel,
                               wrapper, fault)


def _tiled_plain(kernel, h, w, b, k):
    if kernel == "int8":
        w_q, scale, b_p = thead.quantize_head(w.float(), b)
        return thead.reference_head_topk_int8(h.float(), w_q, scale, b_p, k)
    return thead.reference_head_topk(h.bfloat16(), w.bfloat16(), b, k)


def _tiled_tie_case(card, kernel, N, V=9600, P=16):
    """h one-hot (row i selects pattern row i mod P) and patterns with
    exact ties on both sides of every cluster share boundary of this
    kernel's plan on the card, in every 128-wide tile (so a later-walked
    tile holds a value equal to the running k-th with a lower id: the
    walk of a share starts at a tile rotated by the row block) and across
    whole rows. Float: integer patterns; int8: columns that are copies of
    a few column vectors, so equal columns quantize and dequantize alike.
    Returns (h, w, b, shares)."""
    lib = "head_int8" if kernel == "int8" else "head_topk"
    shares, per = thead.sweep_plan(N, V, thead.cluster_table(lib, card))
    cuts = [c * per * thead.TILE_V for c in range(1, shares)]
    rng = np.random.default_rng(N)
    if kernel == "int8":
        kinds = rng.standard_normal((P, 7)).astype(np.float32)
        kinds[:, 6] = np.abs(kinds[:, 6]) + 4.0
        kind = rng.integers(0, 6, V)
        kind[[c + d for c in cuts for d in (-1, 0)]] = 6
        kind[np.arange(0, V, thead.TILE_V) + 9] = 6
        pat = kinds[:, kind]
    else:
        pat = rng.integers(-2, 2, (P, V)).astype(np.float32)
        pat[0] = 1.0  # the whole row ties
        for cut in cuts:
            pat[1, [cut - 1, cut]] = 5.0
            pat[2, [cut - 2, cut + 1]] = 6.0
            pat[3, [cut - 1, cut, 0, V - 1]] = 3.0
            pat[5, cut - 4:cut + 4] = 4.0
        for c in range(shares):
            pat[4, min(c * per * thead.TILE_V + 5, V - 1)] = 7.0
        for t in range(V // thead.TILE_V):
            pat[6, t * thead.TILE_V + 3] = 9.0  # an equal best in each tile
            pat[7, t * thead.TILE_V + 126:t * thead.TILE_V + 130] = 2.0
    h = np.zeros((N, P), np.float32)
    h[np.arange(N), np.arange(N) % P] = 1.0
    return (torch.from_numpy(h).to(card), torch.from_numpy(pat).to(card),
            torch.zeros((V,), device=card), shares)


def _exact(got, want, kernel):
    lse_atol = 2e-4 if kernel == "int8" else 1e-5
    return (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            and float((got[2] - want[2]).abs().max()) <= lse_atol)


@pytest.mark.parametrize("k", [1, 5, 10, 64])
@pytest.mark.parametrize("N", [1, 33, 2561])
@pytest.mark.parametrize("kernel", ["mask", "thresh", "int8"])
def test_tiled_heads_exact_on_share_and_bar_ties(card, kernel, N, k):
    """The tiled heads (one launch: clusters that split the vocab, the
    extraction per tile, the merge on chip) on ties across every tile, at
    every cluster share boundary and at the running bar, at ragged N:
    values and ids equal to the plain version's, lse within its bar;
    thresh bit-equal to mask."""
    h, w, b, shares = _tiled_tie_case(card, kernel, N)
    assert shares >= 2
    got = _tiled(kernel, h, w, b, k)
    assert _exact(got, _tiled_plain(kernel, h, w, b, k), kernel)
    if kernel == "thresh":
        assert all(torch.equal(x, y)
                   for x, y in zip(got, _tiled("mask", h, w, b, k)))


@pytest.mark.parametrize("kernel", ["mask", "thresh", "int8"])
def test_tiled_heads_planted_faults_fail(card, kernel):
    """Each planted fault of the one-launch design fails the exact bar on
    the tie patterns at N = 2560: a merge that breaks ties to the higher
    id (the kernel on the reversed vocab, ids mapped back), a cluster
    share left out (its columns' bias at HEAD_PAD) and a tile skipped on
    a max equal to the running k-th value (the kernel's fault switch)."""
    N = 2560
    h, w, b, _ = _tiled_tie_case(card, kernel, N)
    V = w.shape[1]
    lib = "head_int8" if kernel == "int8" else "head_topk"
    _, per = thead.sweep_plan(N, V, thead.cluster_table(lib, card))
    for k in (1, 5):
        want = _tiled_plain(kernel, h, w, b, k)
        assert _exact(_tiled(kernel, h, w, b, k), want, kernel)
        v, i, l = _tiled(kernel, h, w.flip(1).contiguous(), b.flip(0), k)
        assert not _exact((v, (V - 1 - i).to(torch.int32), l), want, kernel)
        dropped = b.clone()
        dropped[per * thead.TILE_V:2 * per * thead.TILE_V] = thead.HEAD_PAD
        assert not _exact(_tiled(kernel, h, w, dropped, k), want, kernel)
        assert not _exact(_tiled(kernel, h, w, b, k, fault=1), want, kernel)


def test_tiled_heads_one_launch_and_no_wmma_tile(card):
    """bf16 mask and thresh and the int8 head (given its K-major weights)
    run as one CUDA launch a call, the head_sm90.cuh kernel; no tile pass
    (head_tile_kernel, head_int8_tile_kernel) and no merge launch. Each
    is profiled in a process of its own (``_kernels_a_call``)."""
    for name in ("mask", "thresh", "int8"):
        kernels = _kernels_a_call("heads", name)
        assert sum(kernels.values()) == 3, (name, kernels)
        assert all("head_kernel" in key for key in kernels), (name, kernels)
        assert not any("tile_kernel" in key or "merge" in key
                       for key in kernels)


@pytest.mark.parametrize("over,B", [({**SMALL_CELLS, **F32_CELLS}, 7),
                                    (F32_CELLS, 512)])
def test_fp32_cell_kernels_match_plain(card, over, B):
    """compute_dtype="float32": att_cell, lang_cell, dcnet_score and
    dcnet_cell through their fp32 instances within 1e-5 of their plain
    versions (fp32 sums in another order)."""
    mc, pack, (h_att, c_att, h_lang, c_lang), emb = _cell_setup(
        "editnet", over, card, B)
    assert pack.dtype == torch.float32
    got = megastep.att_cell(pack, emb, h_att, c_att, h_lang)
    want = megastep.reference_att_cell(pack, emb, h_att, c_att, h_lang)
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.float32
        torch.testing.assert_close(g_, w_, atol=1e-5, rtol=0)
    vhat = megastep._grouped(want[2], pack.features)
    c_star = megastep._grouped(want[3], pack.enc_cs)
    got = megastep.lang_cell(pack, vhat, want[0], h_lang, c_lang, c_star)
    want = megastep.reference_lang_cell(pack, vhat, want[0], h_lang, c_lang,
                                        c_star)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, atol=1e-5, rtol=0)
    _, dpack, (h, c, _, _), demb = _cell_setup("dcnet", over, card, B)
    got = megastep.dcnet_score(dpack, h)
    want = megastep.reference_dcnet_score(dpack, h)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    ctx = megastep._grouped(want, dpack.enc_hs)
    got = megastep.dcnet_cell(dpack, demb, ctx, h, c)
    want = megastep.reference_dcnet_cell(dpack, demb, ctx, h, c)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, atol=1e-5, rtol=0)


@pytest.mark.parametrize("copy", [False, True])
@pytest.mark.parametrize("N,D,H", [(8, 128, 128), (5, 48, 72),
                                   (512, 3072, 1024), (65, 2080, 96)])
def test_fp32_lstm_kernels_match_plain(card, N, D, H, copy):
    """B5's fp32 instance within 1e-5 of its plain version; the same
    inputs rounded to bf16 first (a planted fault) fail that bar."""
    params, x, h, c, cs = _lstm_case(card, N, D, H, copy)
    wrapper = tlstm.fused_copy_lstm_cell if copy else tlstm.fused_lstm_cell
    plain = (tlstm.reference_copy_lstm_cell if copy
             else tlstm.reference_lstm_cell)
    tail = (cs,) if copy else ()
    before = wrapper.launches
    got = wrapper(params, x, h, c, *tail, compute_dtype=torch.float32)
    assert wrapper.launches == before + 1
    want = plain(params, x, h, c, *tail, compute_dtype=torch.float32)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, atol=1e-5, rtol=0)
    bad = wrapper(params, x.bfloat16().float(), h, c, *tail,
                  compute_dtype=torch.float32)
    assert max(float((g_ - w_).abs().max()) for g_, w_ in zip(bad, want)) \
        > 1e-5


@pytest.mark.parametrize("B,N,A,V,Q,masked", [
    (8, 36, 512, 2048, 1024, True), (6, 22, 64, 96, 96, True),
    (512, 36, 512, 2048, 1024, False)])
def test_fp32_attention_kernel_matches_plain(card, B, N, A, V, Q, masked):
    """B6's fp32 instance (fp32 keys and values, fp32 query product):
    ctx and weights within 1e-5 of its plain version."""
    params, keys, values, query, mask = _attention_case(card, B, N, A, V, Q,
                                                        masked=masked)
    keys, values = keys.float(), values.float()
    ctx, w = tattn.fused_additive_attention(
        params, keys, values, query, mask, compute_dtype=torch.float32)
    ctx_r, w_r = tattn.reference_additive_attention(
        params, keys, values, query, mask, compute_dtype=torch.float32)
    torch.testing.assert_close(w, w_r, atol=1e-5, rtol=0)
    torch.testing.assert_close(ctx, ctx_r, atol=1e-5, rtol=0)


def _wholestep_args(card, over, B, dt=torch.bfloat16, seed=3, K=5):
    """(pack, the whole-step kernel's arguments) from an encoded batch of
    B images with K beams each."""
    mc, pack, (h_att, c_att, h_lang, c_lang), emb = _cell_setup(
        "editnet", over, card, B, K=K)
    g = torch.Generator().manual_seed(seed)
    H, V = mc.hidden_dim, mc.vocab_size
    w, b = thead.prepad_head(
        (torch.randn((H, V), generator=g) * H ** -0.5).to(card),
        (torch.randn((V,), generator=g) * 0.1).to(card), compute_dtype=dt)
    h2, _, vhat_raw, c_star = megastep.att_phase(
        pack, h_att[:, :H], c_att[:, :H], h_lang[:, :H], emb[:, :mc.emb_dim])
    return pack, (pack, vhat_raw, h2, c_star, h_lang[:, :H].contiguous(),
                  c_lang[:, :H].contiguous(), w, b)


@pytest.mark.parametrize("over,B,k", [({**SMALL_CELLS, **F32_CELLS}, 7, 5),
                                      ({**SMALL_CELLS, **F32_CELLS}, 3, 16),
                                      (F32_CELLS, 512, 5)])
def test_fp32_wholestep_kernel_matches_plain(card, over, B, k):
    """The whole step's fp32 route within 1e-5 of its plain version (h, c,
    vals, lse), idx agreement >= 0.999."""
    _, args = _wholestep_args(card, over, B, torch.float32)
    before = twhole.fused_lang_head_topk.launches
    got = twhole.fused_lang_head_topk(*args, k=k)
    assert twhole.fused_lang_head_topk.launches == before + 1
    want = twhole.reference_lang_head_topk(*args, k=k)
    for i in (0, 1, 2, 4):
        torch.testing.assert_close(got[i], want[i], atol=1e-5, rtol=0)
    assert float((got[3] == want[3]).float().mean()) >= 0.999


@pytest.mark.parametrize("F", [48, 2080])
@pytest.mark.parametrize("N", [1, 65, 2561])
def test_sm90_lang_cell_ragged_shapes(card, N, F):
    """The sm90 lang cell and the whole-step kernel at row counts that
    leave partial 128-row tiles (N = 1, 65, 2561) and feature widths that
    pad to one and to 17 column blocks (F = 48, 2080): h, c within 1e-3;
    the whole step's head within its bar."""
    B, K = {1: (1, 1), 65: (13, 5), 2561: (2561, 1)}[N]
    over = {"model.feat_dim": F}
    pack, args = _wholestep_args(card, over, B, K=K)
    _, vhat, h2, c_star, h_lang, c_lang, _, _ = args
    got = megastep.lang_cell(pack, vhat, h2, h_lang, c_lang, c_star)
    want = megastep.reference_lang_cell(pack, vhat, h2, h_lang, c_lang,
                                        c_star)
    for g_, w_ in zip(got, want):
        assert tuple(g_.shape) == (N, pack.hp)
        torch.testing.assert_close(g_, w_, atol=1e-3, rtol=0)
    got = twhole.fused_lang_head_topk(*args, k=5)
    want = twhole.reference_lang_head_topk(*args, k=5)
    for g_, w_ in zip(got[:2], want[:2]):
        torch.testing.assert_close(g_, w_, atol=1e-3, rtol=0)
    _head_bar(got[2:], want[2:], "mask")


def test_sm90_lang_cell_planted_faults_fail(card):
    """The bar catches, in the sm90 lang cell and the whole-step kernel, a
    pack whose Copy-LSTM reads the gates of two hidden columns crossed and
    one whose copy gate drops the c* K range."""
    mc, pack, (h_att, c_att, h_lang, c_lang), emb = _cell_setup(
        "editnet", PAPER_CELLS, card, 7)
    H, Hp = mc.hidden_dim, pack.hp
    h2, _, vhat, c_star = megastep.att_phase(
        pack, h_att[:, :H], c_att[:, :H], h_lang[:, :H], emb[:, :mc.emb_dim])
    want = megastep.reference_lang_cell(pack, vhat, h2, h_lang, c_lang,
                                        c_star)
    crossed = dataclasses.replace(pack, lang_w=torch.cat(
        [pack.lang_w[:, :Hp].reshape(-1, Hp // 2, 2).flip(-1).reshape(-1, Hp),
         pack.lang_w[:, Hp:]], dim=1).contiguous())
    no_copy_k = dataclasses.replace(pack, wr=torch.cat(
        [pack.wr[:-Hp], torch.zeros_like(pack.wr[-Hp:])]).contiguous())
    for bad in (crossed, no_copy_k):
        got = megastep.lang_cell(bad, vhat, h2, h_lang, c_lang, c_star)
        err = max(float((g_ - w_).abs().max()) for g_, w_ in zip(got, want))
        assert err > 1e-3
    _, args = _wholestep_args(card, PAPER_CELLS, 7)
    want = twhole.reference_lang_head_topk(*args, k=5)
    for bad in (crossed, no_copy_k):
        got = twhole.fused_lang_head_topk(bad, *args[1:], k=5)
        assert float((got[0] - want[0]).abs().max()) > 1e-3


NARROW_CELLS = {"model.emb_dim": 48, "model.hidden_dim": 48}  # one block


def _cross_hidden(w, hp):
    """A gate-major [..., 4Hp] tensor whose i-gate columns of hidden
    columns 2m and 2m + 1 are exchanged: an LSTM epilogue that reads the
    gates of two hidden columns crossed."""
    i = w[..., :hp]
    crossed = i.reshape(*i.shape[:-1], hp // 2, 2).flip(-1).reshape(i.shape)
    return torch.cat([crossed, w[..., hp:]], dim=-1).contiguous()


def _att_and_dcnet_cells(card, arch, over, B, K=5):
    """(pack, arguments, the kernel's outputs, the plain version's) of
    att_cell or dcnet_cell on an encoded batch of B images x K beams."""
    _, pack, (h, c, h2, _), emb = _cell_setup(arch, over, card, B, K=K)
    if arch == "editnet":
        args = (emb, h, c, h2)
        return (pack, args, megastep.att_cell(pack, *args),
                megastep.reference_att_cell(pack, *args))
    omega = megastep.reference_dcnet_score(pack, h)
    args = (emb, megastep._grouped(omega, pack.enc_hs), h, c)
    return (pack, args, megastep.dcnet_cell(pack, *args),
            megastep.reference_dcnet_cell(pack, *args))


@pytest.mark.parametrize("width", ["narrow", "paper"])
@pytest.mark.parametrize("N", [1, 65, 2561])
@pytest.mark.parametrize("arch", ["editnet", "dcnet"])
def test_sm90_att_and_dcnet_cells_ragged_shapes(card, arch, N, width):
    """att_cell and dcnet_cell on sm90_cell.cuh at row counts that leave
    partial 128-row tiles (N = 1, 65, 2561) and at widths that pad to one
    128 block (E = H = 48) or are the paper's: h, c within 1e-3, α and β
    within one bf16 ulp; one counted launch a call."""
    B, K = {1: (1, 1), 65: (13, 5), 2561: (2561, 1)}[N]
    over = NARROW_CELLS if width == "narrow" else PAPER_CELLS
    wrapper = megastep.att_cell if arch == "editnet" else megastep.dcnet_cell
    before = wrapper.launches
    pack, _, got, want = _att_and_dcnet_cells(card, arch, over, B, K)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    for g_, w_ in zip(got[:2], want[:2]):
        assert tuple(g_.shape) == (N, pack.hp)
        torch.testing.assert_close(g_, w_, atol=1e-3, rtol=0)
    for g_, w_ in zip(got[2:], want[2:]):
        assert g_.dtype == torch.bfloat16
        _weights_close(g_, w_)


def test_sm90_att_and_dcnet_cells_planted_faults_fail(card):
    """The bar catches, in att_cell, a pack whose LSTM reads the gates of
    two hidden columns crossed and one whose zvb is dropped; in
    dcnet_cell, the gates of two hidden columns crossed."""
    for arch in ("editnet", "dcnet"):
        pack, args, _, want = _att_and_dcnet_cells(card, arch, PAPER_CELLS, 7)
        Hp = pack.hp
        if arch == "editnet":
            bad_packs = (
                dataclasses.replace(pack, w_att=_cross_hidden(pack.w_att, Hp),
                                    zvb=_cross_hidden(pack.zvb, Hp)),
                dataclasses.replace(pack, zvb=torch.zeros_like(pack.zvb)))
            run = megastep.att_cell
        else:
            bad_packs = (dataclasses.replace(
                pack, dec_w=_cross_hidden(pack.dec_w, Hp),
                b=_cross_hidden(pack.b, Hp)),)
            run = megastep.dcnet_cell
        for bad in bad_packs:
            got = run(bad, *args)
            err = max(float((g_ - w_).abs().max())
                      for g_, w_ in zip(got[:2], want[:2]))
            assert err > 1e-3


@pytest.mark.parametrize("width", ["narrow", "paper"])
def test_dcnet_cell_context_gate_rounds_once(card, width):
    """The context gate multiplies the fp32 context unrounded and rounds
    once, as the reference does: with gate_w = 0, a random gate_b (a gate
    of 1/2 would commute with rounding) and every ctx value halfway
    between bf16 neighbours, part is bit-equal to bf16(sigmoid(gate_b) *
    ctx); ctx rounded to bf16 first gives another part."""
    over = NARROW_CELLS if width == "narrow" else PAPER_CELLS
    _, pack, (h, c, _, _), emb = _cell_setup("dcnet", over, card, 13)
    g = torch.Generator().manual_seed(5)
    pack = dataclasses.replace(
        pack, gate_w=torch.zeros_like(pack.gate_w),
        gate_b=torch.randn(pack.gate_b.shape, generator=g).to(card))
    x = torch.randn(h.shape, generator=g).to(card)
    ctx = ((x.view(torch.int32) & -65536) | 0x8000).view(torch.float32)
    want = (torch.sigmoid(pack.gate_b) * ctx).to(torch.bfloat16)
    part, bad = (torch.empty_like(want) for _ in range(2))
    megastep.dcnet_cell(pack, emb, ctx, h, c, part=part)
    torch.cuda.synchronize()
    assert torch.equal(part, want)
    megastep.dcnet_cell(pack, emb, ctx.bfloat16().float(), h, c, part=bad)
    assert not torch.equal(bad, want)


@pytest.mark.parametrize("cell_impl", ["xla", "pallas", "wholestep"])
@pytest.mark.parametrize("arch", ["editnet", "dcnet"])
def test_small_fp32_decode_on_card_matches_cpu(card, arch, cell_impl):
    """A small model with compute_dtype="float32" decoded on the card
    (every kernel of its path in its fp32 instance) and on the CPU: the
    same captions for nearly every image; the kernels were launched."""
    cfg = CaptionKitConfig().override({
        **SMALL_CELLS, "model.arch": arch, "model.cell_impl": cell_impl,
        "model.compute_dtype": "float32", "decode.beam_size": 5,
        "decode.max_decode_len": 10})
    model = get_model(cfg.model)
    rng = np.random.default_rng(0)
    B = 16
    feats = torch.from_numpy(
        rng.standard_normal((B, 6, 72)).astype(np.float32))
    ex = torch.from_numpy(rng.integers(4, 300, (B, 8)))
    ln = torch.from_numpy(rng.integers(2, 9, (B,)))
    from captionkit_torch.kernels import WRAPPERS

    out, launched = {}, {}
    for dev in ("cpu", "cuda"):
        params = model.init(0, dev)
        fn = make_decode_fn(model, cfg.decode, start_id=2, end_id=-1,
                            device=dev)
        before = sum(w.launches for w in WRAPPERS)
        out[dev] = fn(params, feats, ex, ln).cpu()
        launched[dev] = sum(w.launches for w in WRAPPERS) - before
    assert launched["cpu"] == 0 and launched["cuda"] >= 10
    rows = (out["cpu"] == out["cuda"]).all(dim=1).float().mean()
    assert float(rows) >= 0.9


@pytest.mark.parametrize("cell_impl", ["xla", "wholestep"])
def test_small_beam10_decode_on_card_matches_cpu(card, cell_impl):
    """decode.beam_size = 10 (k = 10 > 8) through the head kernel and the
    whole-step kernel on the card: the same captions as the CPU for nearly
    every image."""
    cfg = CaptionKitConfig().override({
        **SMALL_CELLS, "model.cell_impl": cell_impl, "decode.beam_size": 10,
        "decode.max_decode_len": 10})
    model = get_model(cfg.model)
    rng = np.random.default_rng(0)
    B = 16
    feats = torch.from_numpy(
        rng.standard_normal((B, 6, 72)).astype(np.float32))
    ex = torch.from_numpy(rng.integers(4, 300, (B, 8)))
    ln = torch.from_numpy(rng.integers(2, 9, (B,)))
    wrapper = (twhole.fused_lang_head_topk if cell_impl == "wholestep"
               else thead.fused_head_topk)
    out = {}
    for dev in ("cpu", "cuda"):
        params = model.init(0, dev)
        fn = make_decode_fn(model, cfg.decode, start_id=2, end_id=-1,
                            device=dev)
        before = wrapper.launches
        out[dev] = fn(params, feats, ex, ln).cpu()
        assert wrapper.launches - before == (10 if dev == "cuda" else 0)
    rows = (out["cpu"] == out["cuda"]).all(dim=1).float().mean()
    assert float(rows) >= 0.9


# -- decoding and scoring a split (decode.beam backptr, cli decode) ----------

SMALL_DECODE = {
    "model.emb_dim": 32, "model.hidden_dim": 64, "model.att_dim": 16,
    "model.feat_dim": 48, "model.num_regions": 6, "decode.beam_size": 5,
    "decode.max_decode_len": 10}


@pytest.mark.parametrize("arch", ["editnet", "dcnet"])
def test_backptr_beam_on_card_equals_register(card, arch):
    """The backpointer and register beam layouts on the card, bf16,
    through the head kernel, with the token the decode emits most often as
    the end id (so hypotheses finish at many steps): every field of the
    result bit-equal."""
    from captionkit_torch.decode.beam import beam_search

    cfg = CaptionKitConfig().override({
        **SMALL_DECODE, "model.arch": arch, "model.vocab_size": 300})
    model = get_model(cfg.model)
    params = model.init(0, card)
    rng = np.random.default_rng(0)
    B = 16
    with torch.inference_mode():
        ctx = model.encode(
            params, torch.from_numpy(rng.standard_normal(
                (B, 6, 48)).astype(np.float32)).to(card),
            torch.from_numpy(rng.integers(4, 300, (B, 8))).to(card),
            torch.from_numpy(rng.integers(2, 9, (B,))).to(card))
        kw = dict(beam_size=5, start_id=2, max_len=10)
        counts = torch.bincount(beam_search(
            model, params, ctx, end_id=-1, **kw).all_tokens.flatten().long())
        counts[0] = 0
        end_id = int(counts.argmax())
        before = thead.fused_head_topk.launches
        out = {impl: beam_search(model, params, ctx, end_id=end_id,
                                 impl=impl, **kw)
               for impl in ("register", "backptr")}
    assert thead.fused_head_topk.launches > before
    for f in out["register"]._fields:
        assert torch.equal(getattr(out["backptr"], f),
                           getattr(out["register"], f)), f
    done = (out["backptr"].all_tokens == end_id).any(dim=2)
    assert len(set(out["backptr"].all_lengths[done].tolist())) > 1


def test_cli_decode_on_card_matches_cpu(card, tmp_path, capsys):
    """``cli decode --synthetic`` on the card (the default device) and with
    ``--device cpu``: the same metric keys, the same captions for nearly
    every image (a near-tie may flip between the devices), and the card's
    run launched the head kernel."""
    from captionkit_torch import cli

    sets = [a for k, v in {**SMALL_DECODE, "decode.batch_size": 8}.items()
            for a in ("--set", f"{k}={v}")]
    argv = ["decode", "--config", "editnet_beam5", "--synthetic",
            "--images", "24", *sets]
    outs = {}
    for dev in ("cuda", "cpu"):
        path = tmp_path / f"{dev}.json"
        before = thead.fused_head_topk.launches
        assert cli.main(argv + ["--out", str(path)] + (
            ["--device", "cpu"] if dev == "cpu" else [])) == 0
        launched = thead.fused_head_topk.launches - before
        assert (launched > 0) == (dev == "cuda")
        outs[dev] = (json.loads(capsys.readouterr().out),
                     json.loads(path.read_text()))
    assert list(outs["cuda"][0]) == list(outs["cpu"][0])
    assert outs["cuda"][0]["captions"] == 24.0
    same = [a["caption"] == b["caption"]
            for a, b in zip(outs["cuda"][1], outs["cpu"][1])]
    assert len(same) == 24 and sum(same) >= 0.9 * 24


# --------------------------------------------------------------------------
# Training: the card's matmul route with a gradient, one train step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("batched", [False, True])
def test_mm_gradient_route_rounds_as_the_cpu_route(card, batched):
    """``nn.cells.mm``/``bmm`` at bf16 on the card (``torch.mm``/``bmm``
    with ``out_dtype`` through ``_MatmulF32Out``) against the CPU route
    (the float32 product of the rounded operands, whose casts round the
    gradients): the products agree to float32 rounding; each operand's
    gradient is a float32 product rounded once to bf16 (so exactly a bf16
    value), and the two devices' agree but for a bf16 rounding that
    float32 sums in another order may flip (one bf16 ulp, in few
    elements)."""
    from captionkit_torch.nn.cells import bmm, mm

    g = torch.Generator().manual_seed(0)
    shape_a, shape_b = ((3, 40, 96), (3, 96, 24)) if batched else \
        ((40, 96), (96, 24))
    a = torch.randn(shape_a, generator=g)
    b = torch.randn(shape_b, generator=g)
    cot = torch.randn((*shape_a[:-1], shape_b[-1]), generator=g)
    fn = bmm if batched else mm
    out = {}
    for dev in ("cpu", "cuda"):
        x = a.to(dev).detach().requires_grad_(True)
        y = b.to(dev).detach().requires_grad_(True)
        z = fn(x, y, torch.bfloat16)
        assert z.dtype == torch.float32
        (z * cot.to(dev)).sum().backward()
        out[dev] = (z.detach().cpu(), x.grad.cpu(), y.grad.cpu())
    # The products: float32 sums of bf16 products in another order.
    assert torch.allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                          atol=1e-5)
    for want, got in zip(out["cpu"][1:], out["cuda"][1:]):
        assert torch.equal(got.bfloat16().float(), got)  # rounded once
        ulp = torch.where(want == 0, torch.ones_like(want),
                          want.abs()) * 2.0 ** -8
        assert bool(((got - want).abs() <= ulp + 1e-6).all())
        assert float((got == want).float().mean()) >= 0.9


SMALL_TRAIN = dict(vocab_size=60, emb_dim=16, hidden_dim=32, att_dim=16,
                   feat_dim=24, num_regions=5, dropout=0.0)


def _train_batch(dev, B=6, T_in=7, T_out=9, seed=0):
    r = np.random.default_rng(seed)
    V = SMALL_TRAIN["vocab_size"]
    tl = np.asarray([9, 3, 6, 2, 9, 5][:B])
    tgt = r.integers(4, V, (B, T_out))
    tgt[:, 0] = 1
    for i in range(B):
        tgt[i, tl[i] - 1] = 2
        tgt[i, tl[i]:] = 0
    return {"features": torch.from_numpy(r.standard_normal(
                (B, 5, 24)).astype(np.float32)).to(dev),
            "existing": torch.from_numpy(r.integers(4, V, (B, T_in))).to(dev),
            "existing_len": torch.from_numpy(
                np.asarray([7, 2, 5, 3, 1, 7][:B])).to(dev),
            "target": torch.from_numpy(tgt).to(dev),
            "target_len": torch.from_numpy(tl).to(dev),
            "valid": torch.ones(B, dtype=torch.bool, device=dev)}


def _xe_grads(model, params, batch):
    from captionkit_torch.params import named_tensors
    from captionkit_torch.train.xe import BATCH_KEYS, xe_loss

    loss, _ = xe_loss(model, params, *(batch[k] for k in BATCH_KEYS),
                      train=True)
    named = named_tensors(params)
    return dict(zip(named, torch.autograd.grad(loss, list(named.values()))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_on_card_matches_plain_loop_and_cpu(card, dtype):
    """One XE step on the card: the deferred backward's gradients against
    autograd through the loop on the card, and the card's deferred
    gradients against the CPU's. Per weight, max |diff| / max |want|
    within 1e-4 (fp32) or 5e-2 (bf16: the routes round the cotangents
    differently), the attentions' query kernels and biases (a cancelling
    sum at its rounding floor) within 0.5. Then a whole train step (SGD,
    so that no Adam normalization blows rounding up) through the deferred
    backward and through the loop: the weights within 1e-6 at fp32."""
    from captionkit_torch.config import ModelConfig, TrainConfig
    from captionkit_torch.params import named_tensors
    from captionkit_torch.train.state import create_train_state
    from captionkit_torch.train.xe import make_xe_train_step

    floor = ("vis_attention/w_q", "vis_attention/b", "scma/w_q", "scma/b")
    tol = 1e-4 if dtype == "float32" else 5e-2
    cfg = ModelConfig(arch="editnet", compute_dtype=dtype, **SMALL_TRAIN)
    models = {"deferred": get_model(cfg), "loop": get_model(
        dataclasses.replace(cfg, deferred_backward=False))}
    tcfg = TrainConfig(seed=3, optimizer="sgd", learning_rate=0.1)

    def state(dev):
        return create_train_state(
            lambda seed: models["deferred"].init(seed, dev), tcfg)

    grads = {
        "card": _xe_grads(models["deferred"], state("cuda").params,
                          _train_batch("cuda")),
        "loop": _xe_grads(models["loop"], state("cuda").params,
                          _train_batch("cuda")),
        "cpu": _xe_grads(models["deferred"], state("cpu").params,
                         _train_batch("cpu"))}
    for want in ("loop", "cpu"):
        for n, g in grads["card"].items():
            w = grads[want][n].cpu()
            err = float((g.cpu() - w).abs().max()
                        / w.abs().max().clamp_min(1e-30))
            assert err <= (0.5 if n in floor else tol), (want, n, err)
    if dtype == "float32":
        after = {}
        for name, model in models.items():
            st, m = make_xe_train_step(model, tcfg)(state("cuda"),
                                                    _train_batch("cuda"))
            assert torch.isfinite(m["loss"]) and st.step == 1
            after[name] = named_tensors(st.params)
        for n, t in after["deferred"].items():
            assert torch.allclose(t, after["loop"][n], atol=1e-6, rtol=0), n


def _scst_setup(dev, n):
    """A small EditNet train state on ``dev`` (fp32, SGD), a batch, and
    fixed sampled tokens, masks and advantages for ``n`` samples."""
    from captionkit_torch.config import ModelConfig, TrainConfig
    from captionkit_torch.train.state import create_train_state

    model = get_model(ModelConfig(arch="editnet", compute_dtype="float32",
                                  **SMALL_TRAIN))
    tcfg = TrainConfig(seed=3, optimizer="sgd", learning_rate=0.1)
    state = create_train_state(lambda seed: model.init(seed, dev), tcfg)
    r = np.random.default_rng(n)
    toks = r.integers(4, SMALL_TRAIN["vocab_size"], (n, 6, 8)).astype(
        np.int32)
    mask = np.zeros((n, 6, 8), bool)
    for i, j in np.ndindex(n, 6):
        mask[i, j, :int(r.integers(1, 9))] = True
    adv = r.standard_normal((n, 6)).astype(np.float32)
    if n == 1:
        toks, mask, adv = toks[0], mask[0], adv[0]
    return (model, tcfg, state, _train_batch(dev),
            *(torch.from_numpy(x).to(dev) for x in (toks, mask, adv)))


@pytest.mark.parametrize("n", [1, 3])
def test_scst_update_on_card_matches_cpu(card, n):
    """One SCST update (n = 1, and n = 3 with one backward a sample) on the
    card and on the CPU, fp32, SGD: the loss and the metrics within 1e-5
    relative, every weight within 1e-6."""
    from captionkit_torch.params import named_tensors
    from captionkit_torch.train.scst import make_scst_update

    out = {}
    for dev in ("cpu", "cuda"):
        model, tcfg, state, batch, toks, mask, adv = _scst_setup(dev, n)
        st, m = make_scst_update(model, tcfg, start_id=1, num_samples=n)(
            state, batch, toks, mask, adv)
        out[dev] = ({k: float(v) for k, v in m.items()},
                    {k: t.detach().cpu() for k, t in
                     named_tensors(st.params).items()})
    for k, v in out["cpu"][0].items():
        assert out["cuda"][0][k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    for k, t in out["cpu"][1].items():
        assert torch.allclose(out["cuda"][1][k], t, atol=1e-6, rtol=0), k


def test_scst_rollout_on_card_reads_the_params_before_a_later_update(card):
    """The pipelined schedule on one stream: a rollout enqueued before an
    in-place update decodes what a rollout of a snapshot of the old
    parameters decodes (the same card, bit-equal); its host copies are the
    card's tokens once its event completed; the greedy leg agrees with the
    CPU's for nearly every row."""
    from captionkit_torch.params import named_tensors, params_from_tensors
    from captionkit_torch.train.scst import (
        host_tokens,
        make_scst_rollout,
        make_scst_update,
    )

    model, tcfg, state, batch, toks, mask, adv = _scst_setup("cuda", 1)
    snap = params_from_tensors({k: t.detach().clone() for k, t in
                                named_tensors(state.params).items()},
                               state.params)
    roll_fn = make_scst_rollout(model, start_id=1, end_id=2, max_len=8)
    gen = torch.Generator(device="cuda")
    roll = roll_fn(state.params, batch, gen.manual_seed(5))
    make_scst_update(model, tcfg, start_id=1)(state, batch, toks, mask, adv)
    assert isinstance(roll["ready"], torch.cuda.Event)
    host = host_tokens(roll, "sample_tokens")
    again = roll_fn(snap, batch, gen.manual_seed(5))
    torch.cuda.synchronize()
    for key in ("sample_tokens", "greedy_tokens"):
        assert torch.equal(roll[key], again[key]), key
    assert np.array_equal(host, roll["sample_tokens"].cpu().numpy())
    assert not all(torch.equal(a, b) for a, b in zip(
        named_tensors(state.params).values(),
        named_tensors(snap).values()))
    cpu_model, _, cpu_state, cpu_batch, *_ = _scst_setup("cpu", 1)
    cpu = make_scst_rollout(cpu_model, start_id=1, end_id=2, max_len=8)(
        cpu_state.params, cpu_batch, torch.Generator().manual_seed(5))
    rows = (cpu["greedy_tokens"] == again["greedy_tokens"].cpu()).all(1)
    assert float(rows.float().mean()) >= 0.8


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("mode", ["logprob", "prob"])
def test_ensemble_beam_on_card_matches_cpu(card, mode, quant):
    """A two-member ensemble of a small fp32 EditNet beam-decoded on the
    card (logprob: the combined head through the fp32 head kernel or the
    int8 kernel at H' = 2H; prob: the full-logits branch) and on the CPU:
    the same captions for nearly every image; the head kernel launched in
    logprob mode only."""
    from captionkit_torch.kernels import WRAPPERS
    from captionkit_torch.models.ensemble import ensemble_model, stack_params

    cfg = CaptionKitConfig().override({
        **SMALL_CELLS, "model.compute_dtype": "float32",
        "model.head_quant": quant, "decode.beam_size": 5,
        "decode.max_decode_len": 10})
    model = ensemble_model(get_model(cfg.model), 2, mode=mode)
    rng = np.random.default_rng(1)
    B = 16
    feats = torch.from_numpy(
        rng.standard_normal((B, 6, 72)).astype(np.float32))
    ex = torch.from_numpy(rng.integers(4, 300, (B, 8)))
    ln = torch.from_numpy(rng.integers(2, 9, (B,)))
    out, launched = {}, {}
    for dev in ("cpu", "cuda"):
        member = get_model(cfg.model)
        params = stack_params([member.init(s, dev) for s in (0, 1)])
        fn = make_decode_fn(model, cfg.decode, start_id=2, end_id=-1,
                            device=dev)
        before = sum(w.launches for w in WRAPPERS)
        out[dev] = fn(params, feats, ex, ln).cpu()
        launched[dev] = sum(w.launches for w in WRAPPERS) - before
    assert launched["cpu"] == 0
    assert (launched["cuda"] >= 10) == (mode == "logprob")
    rows = (out["cpu"] == out["cuda"]).all(dim=1).float().mean()
    assert float(rows) >= 0.9


def test_ensemble_members_launch_their_cell_kernels(card):
    """A two-member bf16 EditNet ensemble with ``cell_impl="pallas"``: each
    step launches att_cell and lang_cell once per member and the combined
    head once (a forced-full decode of 10 steps), and the captions agree
    with the plain-cell ensemble's on most tokens."""
    from captionkit_torch.kernels import WRAPPERS
    from captionkit_torch.models.ensemble import ensemble_model, stack_params

    over = {**SMALL_CELLS, "decode.beam_size": 5,
            "decode.max_decode_len": 10}
    rng = np.random.default_rng(2)
    B = 16
    feats = torch.from_numpy(
        rng.standard_normal((B, 6, 72)).astype(np.float32))
    ex = torch.from_numpy(rng.integers(4, 300, (B, 8)))
    ln = torch.from_numpy(rng.integers(2, 9, (B,)))
    out = {}
    for impl in ("xla", "pallas"):
        cfg = CaptionKitConfig().override({**over,
                                           "model.cell_impl": impl})
        member = get_model(cfg.model)
        params = stack_params([member.init(s, "cuda") for s in (0, 1)])
        fn = make_decode_fn(ensemble_model(member, 2), cfg.decode,
                            start_id=2, end_id=-1, device="cuda")
        for w in WRAPPERS:
            w.launches = 0
        out[impl] = fn(params, feats, ex, ln).cpu()
        launched = {w.__name__: w.launches for w in WRAPPERS}
    assert launched["att_cell"] == launched["lang_cell"] == 2 * 10
    assert launched["fused_head_topk"] == 10
    assert float((out["xla"] == out["pallas"]).float().mean()) >= 0.5


def _gate_setup(tmp_path):
    """A small EditNet twin checkpoint, its fp32 config and a synthetic
    split of 8 images."""
    from captionkit_torch.convert.torch_ref import TorchEditNet
    from captionkit_torch.data import SyntheticCaptionSource

    src = SyntheticCaptionSource(num_images=8, captions_per_image=2,
                                 num_regions=4, feat_dim=10, max_len=12,
                                 seed=3)
    torch.manual_seed(0)
    twin = TorchEditNet(len(src.vocab), 12, 16, 8, 10).eval()
    ckpt = tmp_path / "ckpt.pth"
    torch.save({"epoch": 1, "decoder": twin}, ckpt)
    cfg = CaptionKitConfig().override({
        "model.vocab_size": len(src.vocab), "model.emb_dim": 12,
        "model.hidden_dim": 16, "model.att_dim": 8, "model.feat_dim": 10,
        "model.num_regions": 4, "model.dropout": 0.0,
        "model.compute_dtype": "float32", "decode.max_decode_len": 12,
        "decode.batch_size": 8})
    return src, ckpt, cfg


def test_parity_gate_on_card_matches_cpu(card, tmp_path):
    """The fp32 gate on the card (the twin too) gives the CPU's report:
    greedy identical to the twin, the same beam CIDEr, and the head kernel
    launched 12 times for the split's one batch."""
    from captionkit_torch.convert.gate import run_parity_gate
    from captionkit_torch.kernels.head import fused_head_topk

    src, ckpt, cfg = _gate_setup(tmp_path)
    reports = {}
    for dev in ("cpu", "cuda"):
        before = fused_head_topk.launches
        rep = run_parity_gate(str(ckpt), cfg, src.dataset, device=dev)
        launches = fused_head_topk.launches - before
        rep.pop("seconds")
        reports[dev] = rep
    assert reports["cuda"]["ok"] is True, reports["cuda"]
    assert reports["cuda"] == reports["cpu"]
    assert 0 < launches <= 12  # 12 steps a batch, fewer if all finish


def test_greedy_trace_on_card_matches_greedy_decode(card):
    """bf16 on the card: the traced greedy decode's tokens are
    ``greedy_decode``'s, bit for bit; every distribution sums to 1."""
    from captionkit_torch.decode import (
        greedy_decode,
        greedy_decode_with_attention,
    )

    cfg = CaptionKitConfig().override(SMALL_CELLS)
    model = get_model(cfg.model)
    params = model.init(0, "cuda")
    rng = np.random.default_rng(4)
    B = 32
    ctx = model.encode(
        params, torch.from_numpy(
            rng.standard_normal((B, 6, 72)).astype(np.float32)).cuda(),
        torch.from_numpy(rng.integers(4, 300, (B, 8))).cuda(),
        torch.from_numpy(rng.integers(2, 9, (B,))).cuda())
    kw = dict(start_id=2, end_id=3, max_len=12)
    plain = greedy_decode(model, params, ctx, **kw)
    trace = greedy_decode_with_attention(model, params, ctx, **kw)
    assert torch.equal(plain.tokens, trace.rollout.tokens)
    assert torch.equal(plain.logprobs, trace.rollout.logprobs)
    for arr in trace.attention.values():
        torch.testing.assert_close(arr.sum(-1), torch.ones_like(
            arr[..., 0]), atol=1e-3, rtol=0)


def test_prefetch_on_card_is_byte_equal_and_reuses_buffers_safely(card):
    """Prefetched batches equal the synchronous copy byte for byte; with
    one batch in flight (a ring of two pinned buffers) and a consumer
    whose kernels run long, no batch is overwritten by a later one."""
    from captionkit_torch.data.prefetch import prefetch_to_device
    from captionkit_torch.train.xe import (
        batch_host_tensors,
        batch_to_device_dict,
    )

    rng = np.random.default_rng(0)
    host = [{"features": rng.standard_normal((64, 36, 256)).astype(
                 np.float32),
             "existing": rng.integers(0, 9490, (64, 22)),
             "existing_len": rng.integers(1, 23, (64,)),
             "target": rng.integers(0, 9490, (64, 22)),
             "target_len": rng.integers(1, 23, (64,)),
             "valid": rng.random(64) > 0.1} for _ in range(3)]
    got = list(prefetch_to_device((batch_host_tensors(h) for h in host),
                                  device="cuda"))
    for g, h in zip(got, host):
        want = batch_to_device_dict(h, "cuda")
        for k in want:
            assert g[k].dtype == want[k].dtype
            assert torch.equal(g[k], want[k]), k
    big = [np.full((16 << 20,), i, np.float32) for i in range(8)]
    w = torch.randn((4096, 4096), device="cuda")
    for i, t in enumerate(prefetch_to_device(iter(big), size=1,
                                             device="cuda")):
        for _ in range(8):  # keep the stream busy past the next copy
            w = w @ w
            w = w / w.norm()
        assert float(t.min()) == float(t.max()) == float(i)
