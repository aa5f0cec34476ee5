"""The fp32 kernels on the CPU: torch models of how the fp32 head of
``csrc/head_sm90.cuh`` (its F32 operands) and the fp32 gated GEMM of
``csrc/cell_common.cuh`` split one call (the kernels themselves run on a
card: test_torch_card.py), held against ``captionkit.ops.head``'s
``fused_head_topk`` (``extract="mask"``, ``"thresh"``) and
``_sweep_head_topk`` and ``captionkit.ops.lstm``'s fused LSTM and
Copy-LSTM cells, in fp32 and in interpret mode.

The head model: each block of 64 rows is a cluster of ``shares`` CTAs
(``sweep_plan`` over the fp32 kernel's cluster table, up to 8 shares) that
split the vocab tiles; each CTA walks its share from a tile rotated by the
row block; a tile's logits are summed stage by stage, 64 K a stage, h
streamed beside W (zeros past H); warpgroup wg owns the rows [32 wg, 32 wg
+ 32) and folds every tile of the share into their running (m, s) and
top-k (the tiled heads' extraction, or the sweep's exact list); the merge
takes each row's state from every share by (value descending, id
ascending).

The cell model: a CTA owns 128 rows and 32 hidden columns (the i, f, g, o
boxes of gate-major weights, and r); one producer fills a ring of 4 stages
of 32 K, operand after operand (c* feeds r alone), up to 4 stages ahead of
the consumers, which read each stage from its slot; the gated epilogue is
the plain cell's arithmetic.

Planted faults (a share or a column block left out, an off-by-one stage, a
K range skipped) must each fail the bar the models meet: indices and values
equal on integer ties at share and tile boundaries with the log-sum-exp
within 1e-5, cells within 2e-5 (fp32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionkit.nn.cells import CopyLSTMParams as JaxCopyParams
from captionkit.nn.cells import LSTMParams as JaxLSTMParams
from captionkit.ops import head as jhead
from captionkit.ops.lstm import fused_copy_lstm_cell as jax_copy
from captionkit.ops.lstm import fused_lstm_cell as jax_lstm

from captionkit_torch.kernels import head as thead

# Clusters of s CTAs (index s, 1 .. 8) of the fp32 head an H100 80GB HBM3
# holds at once (ck_head_sweep_f32_max_clusters there).
F32_CLUSTERS = (0, 132, 66, 39, 30, 22, 17, 15, 15)
N, H, V = 130, 160, 2500  # 3 row blocks, 3 stages (64, 64, 32), 20 tiles
KS = 64  # K a head stage
INT_MAX = 2 ** 31 - 1
HEAD_FAULTS = ("dropped_share", "off_by_one_stage", "skipped_k_range")
CELL_FAULTS = ("dropped_block", "off_by_one_stage", "skipped_k_range")


def _plan():
    shares, per = thead.sweep_plan(N, V, F32_CLUSTERS)
    assert (shares, per) == (7, 3)  # 6 full shares, a short one, all wrap
    return shares, per


def _sorted(v, i, k):
    """The first k of (v, i) [R, C] by value descending, then id
    ascending."""
    i, by_id = torch.sort(i, dim=1, stable=True)
    v = torch.gather(v, 1, by_id)
    v, by_val = torch.sort(v, dim=1, descending=True, stable=True)
    return v[:, :k], torch.gather(i, 1, by_val)[:, :k]


def _tile_logits(h, w, b, rows, tile, fault):
    """One tile's logits [R, 128] as the F32 consumers sum them: stage
    after stage of 64 K (the A boxes streamed with W's, zeros past H), then
    the bias; columns past V at -inf."""
    cols = torch.arange(tile * thead.TILE_V, (tile + 1) * thead.TILE_V)
    live = cols < w.shape[1]
    stages = -(-h.shape[1] // KS)
    hp = torch.nn.functional.pad(h[rows], (0, (stages + 1) * KS - h.shape[1]))
    wp = torch.nn.functional.pad(w[:, cols[live]],
                                 (0, 0, 0, stages * KS - w.shape[0]))
    acc = torch.zeros((len(rows), int(live.sum())))
    for kb in range(stages):
        if fault == "skipped_k_range" and kb == stages - 1:
            continue
        ka = kb + 1 if fault == "off_by_one_stage" else kb  # A's stage
        acc = acc + hp[:, ka * KS:(ka + 1) * KS] @ wp[kb * KS:(kb + 1) * KS]
    x = torch.full((len(rows), thead.TILE_V), -torch.inf)
    x[:, live] = acc + b[cols[live]]
    return cols, x


def _round(xt, cols, pv, pi, tm, r, extract):
    """One extraction round: the best (value, id) after the last one taken,
    (pv, pi), by the rule ``extract`` names."""
    after = (xt < pv[:, None]) | ((xt == pv[:, None]) & (cols > pi[:, None]))
    if extract == "mask":
        bv = torch.where(after, xt, -torch.inf).max(dim=1).values
        hit = after & (xt == bv[:, None])
    else:
        bv = tm if r == 0 else torch.where(after, xt, -torch.inf).max(
            dim=1).values
        hit = (xt == bv[:, None]) & ((bv < pv)[:, None]
                                     | (cols > pi[:, None]))
    bi = torch.where(hit, cols, INT_MAX).min(dim=1).values
    return bv, bi


def _fold(tiles, k, extract):
    """A warpgroup's walk over its share's tiles [(cols, x [R, 128])]:
    online (m, s) and the running top-k (the tiled heads' rounds, skipped
    on a tile max strictly below the bar; the sweep's exact list)."""
    R = tiles[0][1].shape[0] if tiles else 0
    m = torch.full((R,), -torch.inf, dtype=torch.float64)
    s = torch.zeros((R,), dtype=torch.float64)
    lv = torch.full((R, k), -torch.inf)
    li = torch.full((R, k), INT_MAX, dtype=torch.int64)
    for cols, xt in tiles:
        tm = xt.max(dim=1).values
        m_new = torch.maximum(m, tm.double())
        s = s * torch.exp(m - m_new) + torch.exp(
            xt.double() - m_new[:, None]).sum(dim=1)
        m = m_new
        if extract == "sweep":
            lv, li = _sorted(torch.cat([lv, xt], 1),
                             torch.cat([li, cols.expand(R, -1)], 1), k)
            continue
        bar_v, bar_i = lv[:, k - 1], li[:, k - 1]
        live = ~(tm < bar_v)
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


def _head_model(h, w, b, k, extract, fault=None):
    """(vals, idx, lse) of one call of the fp32 head kernel, as it splits
    the work."""
    shares, per = _plan()
    n_tiles = -(-w.shape[1] // thead.TILE_V)
    outs = []
    for y in range(-(-h.shape[0] // thead.SWEEP_ROWS)):
        block = torch.arange(y * thead.SWEEP_ROWS,
                             min(h.shape[0], (y + 1) * thead.SWEEP_ROWS))
        parts = []
        for c in range(shares):
            if fault == "dropped_share" and c == 1:
                continue
            my = max(0, min(n_tiles, c * per + per) - c * per)
            rot = y % my if my else 0
            walk = [c * per + (t + rot) % my for t in range(my)]
            # Warpgroup wg: the block's rows [32 wg, 32 wg + 32), every
            # tile of the share.
            states = []
            for wg in (0, 1):
                rows = block[32 * wg:32 * wg + 32]
                if len(rows) == 0:
                    continue
                states.append(_fold([_tile_logits(h, w, b, rows, t, fault)
                                     for t in walk], k, extract)
                              if walk else _fold([], k, extract))
            if not walk:  # an empty share's states are all empty
                R = len(block)
                states = [(torch.full((R,), -torch.inf, dtype=torch.float64),
                           torch.zeros((R,), dtype=torch.float64),
                           torch.full((R, k), -torch.inf),
                           torch.full((R, k), INT_MAX, dtype=torch.int64))]
            parts.append(tuple(torch.cat([s_[i] for s_ in states])
                               for i in range(4)))
        ms = torch.stack([p[0] for p in parts], 1)
        M = ms.max(dim=1).values
        S = sum(torch.where(p[0] == -torch.inf, 0.0,
                            p[1] * torch.exp(p[0] - M)) for p in parts)
        v, i = _sorted(torch.cat([p[2] for p in parts], 1),
                       torch.cat([p[3] for p in parts], 1), k)
        outs.append((v, i, M + torch.log(S)))
    return (torch.cat([o[0] for o in outs]),
            torch.cat([o[1] for o in outs]).to(torch.int32),
            torch.cat([o[2] for o in outs]).float())


def _tie_pattern():
    """h [N, H] one-hot (row i selects pattern row i; rows 64 .. 127 sit in
    the second stage, 128 and 129 in the third) and w [H, V] integer
    patterns with ties on share and tile boundaries, so the logits are
    exact."""
    shares, per = _plan()
    cuts = [c * per * thead.TILE_V for c in range(1, shares)]
    rng = np.random.default_rng(15)
    pat = rng.integers(-2, 2, (H, V)).astype(np.float32)
    for p in (0, 64, 128):
        pat[p] = 1.0  # the whole row ties: every tile's max is at the bar
    for cut in cuts:
        for p in (1, 65, 129):
            pat[p, [cut - 1, cut]] = 5.0  # the best pair straddles a cut
        pat[2, [cut - 2, cut + 1]] = 6.0
        pat[3, [cut - 1, cut, 0, V - 1]] = 3.0
        pat[5, cut - 4:cut + 4] = 4.0  # a run across the cut
    for c in range(shares):  # an equal best in every share
        pat[4, c * per * thead.TILE_V + 5] = 7.0
    for t in range(-(-V // thead.TILE_V)):  # an equal best in every tile
        pat[6, min(V - 1, t * thead.TILE_V + 3)] = 9.0
        pat[7, [t * thead.TILE_V + 126, t * thead.TILE_V + 127,
                (t * thead.TILE_V + 128) % V]
            if t * thead.TILE_V + 127 < V else [V - 1]] = 2.0
    h = np.zeros((N, H), np.float32)
    h[np.arange(N), np.arange(N)] = 1.0
    b = np.zeros((V,), np.float32)
    b[::97] = 1.0  # integer bias on some columns
    return h, pat, b


def _jax_head(h, w, b, k, extract):
    args = (jnp.asarray(h), jnp.asarray(w), jnp.asarray(b))
    if extract == "sweep":
        return jhead._sweep_head_topk(*args, k=k, compute_dtype=jnp.float32,
                                      interpret=True)
    return jhead.fused_head_topk(*args, k=k, interpret=True, extract=extract)


def _head_case(k, extract, fault=None, pattern=_tie_pattern):
    h, w, b = pattern()
    got = _head_model(*(torch.from_numpy(x) for x in (h, w, b)), k, extract,
                      fault)
    return got, _jax_head(h, w, b, k, extract)


def _head_same(got, want):
    """The exact bar: ids and values equal, log-sum-exp within 1e-5."""
    gv, gi, gl = (x.numpy() for x in got)
    wv, wi, wl = (np.asarray(x) for x in want)
    return (np.array_equal(gi, wi) and np.array_equal(gv, wv)
            and np.allclose(gl, wl, atol=1e-5, rtol=0))


@pytest.mark.parametrize("extract", ["mask", "thresh", "sweep"])
@pytest.mark.parametrize("k", [1, 5, 16])
def test_f32_head_model_matches_jax(k, extract):
    """The fp32 head's split of a call gives the reference's top-k bit for
    bit on integer ties at share and tile boundaries (V not a multiple of
    the tile, ragged rows, three stages), and its log-sum-exp within
    1e-5."""
    got, want = _head_case(k, extract)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=1e-5, rtol=0)
    # Rows 0, 64 and 128 tie over the whole vocab but the biased columns:
    # those first, then the lowest ids.
    _, w, b = _tie_pattern()
    for row in (0, 64, 128):
        want_ids = np.argsort(-(w[row] + b), kind="stable")[:k]
        assert got[1][row].tolist() == want_ids.tolist()


def _random_pattern():
    rng = np.random.default_rng(4)
    return (rng.standard_normal((N, H)).astype(np.float32),
            (rng.standard_normal((H, V)) * 0.1).astype(np.float32),
            (rng.standard_normal((V,)) * 0.01).astype(np.float32))


@pytest.mark.parametrize("extract", ["mask", "sweep"])
def test_f32_head_model_on_random_logits(extract):
    """Random fp32 operands: values and log-sum-exp within 1e-5 (fp32 sums
    of 160 products in another order), ids agreeing on >= 0.99 of the
    entries (near ties may swap)."""
    got, want = _head_case(5, extract, pattern=_random_pattern)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=1e-5, rtol=0)
    assert (got[1].numpy() == np.asarray(want[1])).mean() >= 0.99


@pytest.mark.parametrize("fault", HEAD_FAULTS)
def test_f32_head_planted_faults_fail(fault):
    """A share left out, A read one stage ahead of W, and the last K range
    skipped each break the exact bar on the tie patterns, for the tiled
    heads' extraction and the sweep."""
    for extract in ("mask", "sweep"):
        got, want = _head_case(5, extract, fault)
        assert not _head_same(got, want), (fault, extract)


# ---------------------------------------------------------------------------
# The fp32 gated GEMM (cell_common.cuh)
# ---------------------------------------------------------------------------

CELL_ROWS, CELL_BOX, STAGE_K, RING = 128, 32, 32, 4
CB, CD, CH = 200, 96, 64  # 2 row blocks (one ragged), 2 column blocks
CELL_ATOL = 2e-5


def _sig(x):
    return 1.0 / (1.0 + torch.exp(-x))


def _cell_model(ops, hid, bias, c_prev, c_star=None, bias_r=None,
                fault=None):
    """(h', c') of one call of the fp32 gated GEMM: ops [(a [N, k], w_gates
    [k, 4 hid] or None, w_copy [k, hid] or None)], successive K ranges of
    one accumulation; r-only operands (c*) feed the copy gate alone."""
    n = ops[0][0].shape[0]
    copy = c_star is not None
    h_out = torch.zeros((n, hid))
    c_out = torch.zeros((n, hid))
    stages = [(s, k0) for s, (a, _, _) in enumerate(ops)
              for k0 in range(0, a.shape[1], STAGE_K)
              if not (fault == "skipped_k_range" and s == 1)]
    for y in range(-(-n // CELL_ROWS)):
        rows = torch.arange(y * CELL_ROWS, min(n, (y + 1) * CELL_ROWS))
        for nb in range(hid // CELL_BOX):
            if fault == "dropped_block" and nb == 1:
                continue
            cols = torch.arange(nb * CELL_BOX, (nb + 1) * CELL_BOX)

            def load(stage):  # the producer: one stage's boxes
                s, k0 = stage
                a, wg, wc = ops[s]
                ks = slice(k0, k0 + STAGE_K)
                base = None if wg is None else torch.stack(
                    [wg[ks][:, g * hid + cols] for g in range(4)])
                r = wc[ks][:, cols] if copy and wc is not None else None
                return a[rows][:, ks], base, r

            acc = torch.zeros((len(rows), 5, CELL_BOX))
            ring, filled = [None] * RING, 0
            for it in range(len(stages)):
                while filled < min(len(stages), it + RING):  # up to 4 ahead
                    ring[filled % RING] = load(stages[filled])
                    filled += 1
                slot = (it + 1) % RING if fault == "off_by_one_stage" \
                    else it % RING
                a_box, base, r = ring[slot]
                if base is not None:
                    for g in range(4):
                        acc[:, g] += a_box @ base[g]
                if r is not None:
                    acc[:, 4] += a_box @ r
            z = [acc[:, g] + bias[g * hid + cols] for g in range(4)]
            c_new = _sig(z[1]) * c_prev[rows][:, cols] \
                + _sig(z[0]) * torch.tanh(z[2])
            if copy:
                rg = _sig(acc[:, 4] + bias_r[cols])
                c_new = rg * c_star[rows][:, cols] + (1.0 - rg) * c_new
            h_out[rows[:, None], cols] = _sig(z[3]) * torch.tanh(c_new)
            c_out[rows[:, None], cols] = c_new
    return h_out, c_out


def _cell_arrays(copy, seed):
    rng = np.random.default_rng(seed)
    s = CH ** -0.5

    def u(*shape):
        return rng.uniform(-s, s, shape).astype(np.float32)

    base = dict(wx=u(CD, 4 * CH), wh=u(CH, 4 * CH), b=u(4 * CH))
    extra = dict(wrx=u(CD, CH), wrh=u(CH, CH), wrc=u(CH, CH), br=u(CH)) \
        if copy else {}
    x, h, c, cs = (rng.standard_normal(shape).astype(np.float32)
                   for shape in ((CB, CD), (CB, CH), (CB, CH), (CB, CH)))
    return base, extra, x, h, c, cs


def _cell_case(copy, fault=None):
    base, extra, x, h, c, cs = _cell_arrays(copy, 21 if copy else 20)
    t = {k: torch.from_numpy(v) for k, v in {**base, **extra}.items()}
    tx, th, tc, tcs = (torch.from_numpy(v) for v in (x, h, c, cs))
    jb = JaxLSTMParams(**{k: jnp.asarray(v) for k, v in base.items()})
    if copy:
        ops = [(tx, t["wx"], t["wrx"]), (th, t["wh"], t["wrh"]),
               (tcs, None, t["wrc"])]
        got = _cell_model(ops, CH, t["b"], tc, tcs, t["br"], fault)
        want = jax_copy(JaxCopyParams(
            base=jb, **{k: jnp.asarray(v) for k, v in extra.items()}),
            jnp.asarray(x), jnp.asarray(h), jnp.asarray(c), jnp.asarray(cs),
            compute_dtype=jnp.float32, interpret=True)
    else:
        ops = [(tx, t["wx"], None), (th, t["wh"], None)]
        got = _cell_model(ops, CH, t["b"], tc, fault=fault)
        want = jax_lstm(jb, jnp.asarray(x), jnp.asarray(h), jnp.asarray(c),
                        compute_dtype=jnp.float32, interpret=True)
    return got, want


def _cell_close(got, want):
    return all(np.allclose(g.numpy(), np.asarray(w), atol=CELL_ATOL, rtol=0)
               for g, w in zip(got, want))


@pytest.mark.parametrize("copy", [False, True], ids=["lstm", "copy_lstm"])
def test_f32_cell_model_matches_jax(copy):
    """The fp32 gated GEMM's split of a call (128-row and 32-column blocks,
    a ring of 4 stages of 32 K over the split operands, c* feeding r alone)
    within 2e-5 of the reference's fused cells in fp32."""
    got, want = _cell_case(copy)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (CB, CH)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=CELL_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("fault", CELL_FAULTS)
@pytest.mark.parametrize("copy", [False, True], ids=["lstm", "copy_lstm"])
def test_f32_cell_planted_faults_fail(copy, fault):
    """A column block left out, a stage read from the next ring slot, and
    the h operand's K range skipped each fail the bar."""
    got, want = _cell_case(copy, fault)
    assert not _cell_close(got, want)


def test_f32_plan_takes_up_to_eight_shares():
    """The fp32 head's plan reads shares up to its table's length (8),
    the bf16 and int8 heads' up to 4; at the paper shape on an H100 the
    fp32 head takes 5 shares of 15 tiles (two waves), the bf16 sweep 2 of
    38."""
    assert thead.F32_MAX_SHARES == 8 and thead.SWEEP_MAX_SHARES == 4
    assert thead.sweep_plan(2560, 9600, F32_CLUSTERS) == (5, 15)
    assert thead.sweep_plan(2560, 9600, F32_CLUSTERS[:5]) == (2, 38)
    assert thead.sweep_plan(320, 9600, F32_CLUSTERS) == (8, 10)
