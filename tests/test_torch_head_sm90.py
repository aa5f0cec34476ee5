"""The tiled heads' kernels on the CPU: a torch model of how the bf16 and
int8 kernels of ``csrc/head_sm90.cuh`` split one call (the kernels
themselves run on a card: test_torch_card.py), held against
``captionkit.ops.head``'s ``fused_head_topk`` (``extract="mask"`` and
``"thresh"``) and ``fused_head_topk_int8`` in interpret mode.

The model follows the kernels step by step: each block of 64 rows is a
cluster of ``shares`` CTAs (``sweep_plan``) that split the vocab tiles;
each CTA walks its share from a tile rotated by the row block, its two
consumer warpgroups taking alternate tiles; per tile and row, the
extraction that ``extract`` names (k rounds of a mask arg-max, or the
threshold walk), skipped when the tile max is strictly below the running
k-th value and stopped at the first entry that does not beat it, folded
into the warpgroup's running top-k and online (m, s); then the merge of
every warpgroup's partial state by (value descending, id ascending).

The patterns put exact ties on tile and share boundaries, in every tile
(so an equal value at the running bar arrives in a later-walked tile with
a lower id), and in whole rows; each planted fault (ties broken to the
higher id in the merge, a share left out, a tile skipped on a max equal to
the bar) must change the result there. Float: indices and values equal,
log-sum-exp within 1e-5 (the same exact integer logits, exp-sums in
another order); int8: indices equal, values within 2e-5 and log-sum-exp
within 2e-4, the reference's bars for its int8 kernel
(tests/test_head_quant.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionkit.ops import head as jhead

from captionkit_torch.kernels import head as thead

# Clusters of s CTAs (index s) a card holds at once (an H100's 132 SMs).
CLUSTERS = (0, 132, 66, 42, 32)
N, P, V = 200, 16, 2560  # 4 row blocks, 20 tiles: 4 shares of 5 tiles
INT_MAX = 2 ** 31 - 1
FAULTS = ("ties_to_higher_id", "share_left_out", "skip_on_equal")


def _sorted(v, i, k, higher_first=False):
    """The first k of (v, i) [R, C] by value descending, then id ascending
    (descending with ``higher_first``, a planted fault)."""
    i, by_id = torch.sort(i, dim=1, stable=True, descending=higher_first)
    v = torch.gather(v, 1, by_id)
    v, by_val = torch.sort(v, dim=1, descending=True, stable=True)
    return v[:, :k], torch.gather(i, 1, by_val)[:, :k]


def _round(xt, cols, pv, pi, tm, r, extract):
    """One extraction round over a tile's rows: the best (value, id) after
    the last one taken, (pv, pi), by the rule ``extract`` names."""
    after = (xt < pv[:, None]) | ((xt == pv[:, None]) & (cols > pi[:, None]))
    if extract == "mask":  # arg-max over the entries after (pv, pi)
        bv = torch.where(after, xt, -torch.inf).max(dim=1).values
        hit = after & (xt == bv[:, None])
    else:  # thresh: round 1's value is the tile max; then a thresholded max
        bv = tm if r == 0 else torch.where(after, xt, -torch.inf).max(
            dim=1).values
        hit = (xt == bv[:, None]) & ((bv < pv)[:, None]
                                     | (cols > pi[:, None]))
    bi = torch.where(hit, cols, INT_MAX).min(dim=1).values
    return bv, bi


def _warpgroup(x, tiles, k, extract, fault):
    """One consumer warpgroup's walk over its tiles of a row block x
    [R, V]: (m, s, running values, running ids)."""
    R = x.shape[0]
    m = torch.full((R,), -torch.inf, dtype=torch.float64)
    s = torch.zeros((R,), dtype=torch.float64)
    lv = torch.full((R, k), -torch.inf)
    li = torch.full((R, k), INT_MAX, dtype=torch.int64)
    for tile in tiles:
        cols = torch.arange(tile * thead.TILE_V,
                            min(x.shape[1], (tile + 1) * thead.TILE_V))
        xt = x[:, cols]
        tm = xt.max(dim=1).values
        m_new = torch.maximum(m, tm.double())
        s = s * torch.exp(m - m_new) + torch.exp(
            xt.double() - m_new[:, None]).sum(dim=1)
        m = m_new
        bar_v, bar_i = lv[:, k - 1], li[:, k - 1]
        live = tm > bar_v if fault == "skip_on_equal" else ~(tm < bar_v)
        pv = torch.full((R,), torch.inf)
        pi = torch.full((R,), -1, dtype=torch.int64)
        for r in range(k):
            if not bool(live.any()):
                break
            bv, bi = _round(xt, cols, pv, pi, tm, r, extract)
            live &= (bv > bar_v) | ((bv == bar_v) & (bi < bar_i))
            nv, ni = _sorted(torch.cat([lv, bv[:, None]], 1),
                             torch.cat([li, bi[:, None]], 1), k)
            lv = torch.where(live[:, None], nv, lv)
            li = torch.where(live[:, None], ni, li)
            bar_v, bar_i = lv[:, k - 1], li[:, k - 1]
            pv, pi = bv, bi
    return m, s, lv, li


def _kernel_model(logits, k, shares, per, extract="mask", fault=None):
    """(vals, idx, lse) of one call of the kernel, as it splits the work."""
    n_tiles = -(-logits.shape[1] // thead.TILE_V)
    outs = []
    for y in range(-(-logits.shape[0] // thead.SWEEP_ROWS)):
        x = logits[y * thead.SWEEP_ROWS:(y + 1) * thead.SWEEP_ROWS]
        parts = []
        for c in range(shares):
            if fault == "share_left_out" and c == 1:
                continue
            my = max(0, min(n_tiles, c * per + per) - c * per)
            rot = y % my if my else 0
            walk = [c * per + (t + rot) % my for t in range(my)]
            for wg in (0, 1):
                parts.append(_warpgroup(x, walk[wg::2], k, extract, fault))
        ms = torch.stack([p[0] for p in parts], 1)
        M = ms.max(dim=1).values
        S = sum(torch.where(p[0] == -torch.inf, 0.0,
                            p[1] * torch.exp(p[0] - M)) for p in parts)
        v, i = _sorted(torch.cat([p[2] for p in parts], 1),
                       torch.cat([p[3] for p in parts], 1), k,
                       higher_first=fault == "ties_to_higher_id")
        outs.append((v, i, M + torch.log(S)))
    return (torch.cat([o[0] for o in outs]),
            torch.cat([o[1] for o in outs]).to(torch.int32),
            torch.cat([o[2] for o in outs]).float())


def _plan():
    shares, per = thead.sweep_plan(N, V, CLUSTERS)
    assert (shares, per) == (4, 5)  # the walk wraps in every share
    return shares, per


def _float_pattern():
    """h [N, P] one-hot (row i selects pattern row i mod P) and w [P, V]
    integer patterns, so logits row i is pattern row i mod P, exact."""
    shares, per = _plan()
    cuts = [c * per * thead.TILE_V for c in range(1, shares)]
    rng = np.random.default_rng(8)
    pat = rng.integers(-2, 2, (P, V)).astype(np.float32)
    pat[0] = 1.0  # the whole row ties: every tile's max is at the bar
    for cut in cuts:
        pat[1, [cut - 1, cut]] = 5.0  # the best pair straddles a cut
        pat[2, [cut - 2, cut + 1]] = 6.0
        pat[3, [cut - 1, cut, 0, V - 1]] = 3.0
        pat[5, cut - 4:cut + 4] = 4.0  # a run across the cut
    for c in range(shares):  # an equal best in every share
        pat[4, c * per * thead.TILE_V + 5] = 7.0
    for t in range(V // thead.TILE_V):  # an equal best in every tile
        pat[6, t * thead.TILE_V + 3] = 9.0
        pat[7, [t * thead.TILE_V + 126, t * thead.TILE_V + 127,
                (t * thead.TILE_V + 128) % V]] = 2.0  # tile boundaries
        pat[8, t * thead.TILE_V + 2 * (t % 3):t * thead.TILE_V + 6] = 3.0
    h = np.zeros((N, P), np.float32)
    h[np.arange(N), np.arange(N) % P] = 1.0
    return h, pat, np.zeros((V,), np.float32)


def _int8_pattern():
    """h [N, P] one-hot and w [P, V] whose columns are copies of a few
    column vectors, so the quantized logits tie exactly between columns of
    one kind; a column kind above the others sits on every share cut and
    once in every tile."""
    shares, per = _plan()
    rng = np.random.default_rng(9)
    kinds = rng.standard_normal((P, 7)).astype(np.float32)
    kinds[:, 6] = np.abs(kinds[:, 6]) + 4.0
    kind = rng.integers(0, 6, V)
    kind[[c * per * thead.TILE_V + d for c in range(1, shares)
          for d in (-1, 0)]] = 6
    kind[np.arange(0, V, thead.TILE_V) + 9] = 6
    h = np.zeros((N, P), np.float32)
    h[np.arange(N), np.arange(N) % P] = 1.0
    return h, kinds[:, kind], np.zeros((V,), np.float32)


def _float_case(k, extract, fault=None):
    h, w, b = _float_pattern()
    got = _kernel_model(torch.from_numpy(h) @ torch.from_numpy(w)
                        + torch.from_numpy(b), k, *_plan(), extract, fault)
    want = jhead.fused_head_topk(jnp.asarray(h), jnp.asarray(w),
                                 jnp.asarray(b), k=k, interpret=True,
                                 extract=extract)
    return got, want


def _int8_case(k, extract, fault=None):
    h, w, b = _int8_pattern()
    th, tw, tb = (torch.from_numpy(x) for x in (h, w, b))
    w_q, scale, b_p = thead.quantize_head(tw, tb)
    logits = thead.quantized_head_logits(th, w_q, scale, b_p)
    got = _kernel_model(logits, k, *_plan(), extract, fault)
    jw, js, jb = jhead.quantize_head(jnp.asarray(w), jnp.asarray(b),
                                     n_rows=N, k=k)
    want = jhead.fused_head_topk_int8(jnp.asarray(h), jw, js, jb, k=k,
                                      interpret=True, extract=extract)
    return got, want


def _same(got, want, vals_atol, lse_atol):
    gv, gi, gl = (x.numpy() for x in got)
    wv, wi, wl = (np.asarray(x) for x in want)
    return (np.array_equal(gi, wi)
            and np.allclose(gv, wv, atol=vals_atol, rtol=0)
            and np.allclose(gl, wl, atol=lse_atol, rtol=0))


@pytest.mark.parametrize("extract", ["mask", "thresh"])
@pytest.mark.parametrize("k", [1, 5, 8, 16])
def test_float_kernel_model_matches_pallas_interpret(k, extract):
    got, want = _float_case(k, extract)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=1e-5, rtol=0)
    # Row 0 ties over the whole vocab: the lowest ids, whatever the walk.
    assert got[1][0].tolist() == list(range(k))


@pytest.mark.parametrize("extract", ["mask", "thresh"])
@pytest.mark.parametrize("k", [1, 5, 8, 16])
def test_int8_kernel_model_matches_pallas_interpret(k, extract):
    got, want = _int8_case(k, extract)
    assert _same(got, want, 2e-5, 2e-4)
    # The top kind's columns tie: the lowest ids hold the top ranks.
    _, w, _ = _int8_pattern()
    top = np.flatnonzero(w[0] == w[0].max())
    assert got[1][0, :min(k, top.size)].tolist() == top[:k].tolist()


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_change_the_result(fault):
    """Each planted fault of the kernels' partition gives another result
    than the reference on the tie patterns, float and int8, mask and
    thresh, at k = 1 or 5: the bar the card tests hold the kernels to
    catches it."""
    for extract in ("mask", "thresh"):
        caught = []
        for k in (1, 5):
            got, want = _float_case(k, extract, fault)
            caught.append(not _same(got, want, 0.0, 1e-5))
            got, want = _int8_case(k, extract, fault)
            caught.append(not _same(got, want, 2e-5, 2e-4))
        assert any(caught[0::2]) and any(caught[1::2]), (fault, extract)


def test_mask_and_thresh_models_take_the_same_rounds():
    """The two extractions give the same lists on random logits with
    ties, tile by tile (the kernels' thresh is bit-equal to mask)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(-3, 3, (64, 640)).astype(np.float32))
    for k in (1, 3, 8):
        a = _warpgroup(x, [2, 0, 4, 1, 3], k, "mask", None)
        b = _warpgroup(x, [2, 0, 4, 1, 3], k, "thresh", None)
        assert all(torch.equal(p, q) for p, q in zip(a, b))


@pytest.mark.parametrize("n,h,v", [(8, 16, 40), (13, 36, 257),
                                   (64, 64, 1000)])
def test_kmajor_int8_copy_is_the_reference_w_q_transposed(n, h, v):
    """The int8 kernel's K-major weights: byte-equal to the JAX
    quantize_head's w_q transposed over the first V columns, zeros past H
    (rounded up to 16) and in the padded vocab rows."""
    rng = np.random.default_rng(v)
    w = rng.standard_normal((h, v)).astype(np.float32)
    b = rng.standard_normal((v,)).astype(np.float32)
    jw, _, _ = jhead.quantize_head(jnp.asarray(w), jnp.asarray(b),
                                   n_rows=n, k=5)
    w_q, _, _ = thead.quantize_head(torch.from_numpy(w), torch.from_numpy(b))
    w_qt = thead.kmajor_head(w_q)
    hp = -(-h // 16) * 16
    assert w_qt.dtype == torch.int8 and tuple(w_qt.shape) == (
        w_q.shape[1], hp)
    assert w_qt.is_contiguous()
    np.testing.assert_array_equal(w_qt[:v, :h].numpy(),
                                  np.asarray(jw)[:, :v].T)
    assert bool((w_qt[:, h:] == 0).all()) and bool((w_qt[v:] == 0).all())
    # quantize_head's own output keeps the reference's layout.
    np.testing.assert_array_equal(w_q[:, :v].numpy(), np.asarray(jw)[:, :v])
