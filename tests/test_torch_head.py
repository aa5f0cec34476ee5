"""The port's vocab head (``captionkit_torch.kernels.head``) against
``captionkit.ops.head`` on the CPU (the CUDA kernels against their plain
versions on a card are in test_torch_card.py): both extractions
(``extract="mask"``, ``"thresh"``) and the single sweep
(``CAPTIONKIT_HEAD_SWEEP``). The int8 head is in test_torch_head_int8.py.

On the CPU every wrapper takes its plain version; the JAX side runs the
Pallas kernel in interpret mode, as its own tests do. Indices must be
equal; values and log-sum-exp within atol 1e-5 (fp32 sums of the same
products in different orders). The tie patterns are exact in every dtype.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionkit.ops import head as jhead

from captionkit_torch.kernels import head as thead


def _both(h, w, b):
    return ((jnp.asarray(h), jnp.asarray(w), jnp.asarray(b)),
            (torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(b)))


def _assert_same(j, t, atol=1e-5):
    jv, ji, jl = (np.asarray(x) for x in j)
    tv, ti, tl = (x.numpy() for x in t)
    assert ti.dtype == np.int32
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, atol=atol, rtol=0)
    np.testing.assert_allclose(tl, jl, atol=atol, rtol=0)


@pytest.mark.parametrize("N,H,V,k", [
    (16, 32, 300, 5), (24, 64, 130, 3), (8, 16, 128, 1), (40, 48, 1000, 5),
])
def test_plain_head_matches_pallas_interpret(N, H, V, k):
    rng = np.random.default_rng(N + V)
    h = rng.standard_normal((N, H)).astype(np.float32)
    w = rng.standard_normal((H, V)).astype(np.float32)
    b = rng.standard_normal((V,)).astype(np.float32)
    (jh, jw, jb), (th, tw, tb) = _both(h, w, b)
    before = thead.fused_head_topk.launches
    got = thead.fused_head_topk(th, tw, tb, k=k)
    assert thead.fused_head_topk.launches == before  # CPU: no kernel
    _assert_same(jhead.fused_head_topk(jh, jw, jb, k=k, interpret=True), got)
    _assert_same(jhead.reference_head_topk(jh, jw, jb, k=k),
                 thead.reference_head_topk(th, tw, tb, k))


def test_all_equal_logits_give_lowest_ids():
    h = np.ones((8, 16), np.float32)
    w = np.ones((16, 200), np.float32)
    b = np.zeros((200,), np.float32)
    (jh, jw, jb), (th, tw, tb) = _both(h, w, b)
    got = thead.fused_head_topk(th, tw, tb, k=4)
    assert got[1].tolist() == [[0, 1, 2, 3]] * 8
    _assert_same(jhead.fused_head_topk(jh, jw, jb, k=4, interpret=True), got)


def _adversarial():
    """Duplicates that span extraction steps and 128-wide vocab tiles
    (tests/test_ops_pallas.py): h = eye(N), so logits row i is pat[i]."""
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
    return np.eye(N, dtype=np.float32), pat, np.zeros((V,), np.float32)


@pytest.mark.parametrize("extract", ["mask", "thresh"])
def test_adversarial_duplicates(extract):
    h, w, b = _adversarial()
    (jh, jw, jb), (th, tw, tb) = _both(h, w, b)
    before = (thead.fused_head_topk.launches,
              thead.fused_head_topk_thresh.launches)
    got = thead.fused_head_topk(th, tw, tb, k=5, extract=extract)
    assert (thead.fused_head_topk.launches,
            thead.fused_head_topk_thresh.launches) == before  # CPU
    _assert_same(jhead.fused_head_topk(jh, jw, jb, k=5, interpret=True,
                                       tiles=(8, 128), extract=extract),
                 got, atol=1e-6)
    assert got[1][0].tolist() == [7, 130, 300, 12, 260]
    assert got[1][4].tolist()[:3] == [10, 200, 210]
    thresh = thead.fused_head_topk_thresh(th, tw, tb, k=5)
    assert all(torch.equal(a, r) for a, r in zip(thresh, got))


@pytest.mark.parametrize("N,H,V,k", [(16, 32, 300, 5), (40, 48, 1000, 3)])
def test_sweep_matches_pallas_interpret(N, H, V, k):
    """``head_sweep_topk`` against the reference's ``_sweep_head_topk``."""
    rng = np.random.default_rng(N * V)
    h = rng.standard_normal((N, H)).astype(np.float32)
    w = rng.standard_normal((H, V)).astype(np.float32)
    b = rng.standard_normal((V,)).astype(np.float32)
    (jh, jw, jb), (th, tw, tb) = _both(h, w, b)
    before = thead.head_sweep_topk.launches
    got = thead.head_sweep_topk(th, tw, tb, k=k)
    assert thead.head_sweep_topk.launches == before  # CPU: no kernel
    _assert_same(jhead._sweep_head_topk(jh, jw, jb, k=k,
                                        compute_dtype=jnp.float32,
                                        interpret=True), got)


def test_sweep_flag_routes_the_head(monkeypatch):
    """With SWEEP set, ``fused_head_topk`` runs the sweep whatever the
    extraction; the flag is read from CAPTIONKIT_HEAD_SWEEP at import."""
    h, w, b = _adversarial()
    th, tw, tb = (torch.from_numpy(x) for x in (h, w, b))
    called = []

    def sweep(*a, **kw):
        called.append(kw["k"])
        return thead.reference_head_topk(*a, kw["k"])

    monkeypatch.setattr(thead, "head_sweep_topk", sweep)
    monkeypatch.setattr(thead, "SWEEP", True)
    thead.fused_head_topk(th, tw, tb, k=5, extract="thresh")
    thead.fused_head_topk(th, tw, tb, k=3)
    assert called == [5, 3]
    code = ("import captionkit_torch.kernels.head as h; "
            "print(h.SWEEP)")
    env = dict(os.environ, CAPTIONKIT_HEAD_SWEEP="1")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=Path(__file__).resolve().parent.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "True", out.stderr[-2000:]


def test_unknown_extract_raises():
    h, w, b = _adversarial()
    th, tw, tb = (torch.from_numpy(x) for x in (h, w, b))
    with pytest.raises(ValueError, match="extract"):
        thead.fused_head_topk(th, tw, tb, k=5, extract="sort")


def test_prepad_head_pads_with_head_constant():
    rng = np.random.default_rng(2)
    H, V = 16, 300
    w = torch.from_numpy(rng.standard_normal((H, V)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((V,)).astype(np.float32))
    w_p, b_p = thead.prepad_head(w, b, compute_dtype=torch.bfloat16)
    assert tuple(w_p.shape) == (H, 384) and w_p.dtype == torch.bfloat16
    assert thead.HEAD_PAD == -1e30
    assert bool((b_p[V:] == -1e30).all()) and bool((w_p[:, V:] == 0).all())
    # The JAX twin pads to the same columns and values.
    jw_p, jb_p = jhead.prepad_head(jnp.asarray(w.numpy()),
                                   jnp.asarray(b.numpy()), n_rows=8, k=5,
                                   compute_dtype=jnp.bfloat16)
    assert jw_p.shape[1] % 128 == 0
    n = min(jw_p.shape[1], w_p.shape[1])
    np.testing.assert_array_equal(
        np.asarray(jw_p[:, :n].astype(jnp.float32)), w_p[:, :n].float())
    np.testing.assert_array_equal(np.asarray(jb_p[:n]), b_p[:n])
    # Padding changes nothing: same top-k and log-sum-exp as unpadded.
    h = torch.from_numpy(rng.standard_normal((8, H)).astype(np.float32))
    h = h.bfloat16()
    a = thead.fused_head_topk(h, w_p, b_p, k=5)
    r = thead.reference_head_topk(h, w.bfloat16(), b, 5)
    assert torch.equal(a[1], r[1])
    torch.testing.assert_close(a[0], r[0], atol=1e-6, rtol=0)
    torch.testing.assert_close(a[2], r[2], atol=1e-5, rtol=0)


# Clusters of s CTAs (index s) a card might hold at once: every SM's worth
# (132 SMs, in GPCs of 16 or 18), and one with room for fewer of 3 and 4.
CLUSTERS = {"even": (0, 132, 66, 42, 32), "tight": (0, 132, 66, 36, 30)}


@pytest.mark.parametrize("card", list(CLUSTERS))
@pytest.mark.parametrize("N,V", [(1, 9600), (33, 384), (2560, 9600),
                                 (2561, 9600), (130, 200), (64, 8),
                                 (20000, 9600)])
def test_sweep_plan(N, V, card):
    """The sweep's launch plan: at most 4 shares and never more than the
    vocab tiles; the shares together cover every tile; no other share
    count runs fewer waves x tiles per share on the card."""
    clusters = CLUSTERS[card]
    shares, per = thead.sweep_plan(N, V, clusters)
    tiles = -(-V // thead.TILE_V)
    blocks = -(-N // thead.SWEEP_ROWS)
    assert 1 <= shares <= min(thead.SWEEP_MAX_SHARES, tiles)
    assert per == -(-tiles // shares) and shares * per >= tiles

    def cost(s):
        return -(-blocks // clusters[s]) * -(-tiles // s)

    assert all(cost(shares) <= cost(s)
               for s in range(1, min(thead.SWEEP_MAX_SHARES, tiles) + 1))
    if (N, V, card) == (2560, 9600, "even"):  # 40 clusters of 3 in a wave
        assert (shares, per) == (3, 25)


def _share_merge(logits, k, shares, per):
    """The sweep kernel's arithmetic in torch: each cluster share's (max,
    exp-sum, top-k) over its vocab tiles, then the on-chip merge: lse = M +
    log sum_j s_j exp(m_j - M) and the top-k of the shares' candidates by
    (value descending, id ascending)."""
    from captionkit_torch.nn.topk import topk_lowest_index

    V = logits.shape[1]
    ms, ss, cand_v, cand_i = [], [], [], []
    for c in range(shares):
        lo, hi = c * per * thead.TILE_V, min(V, (c + 1) * per * thead.TILE_V)
        if lo >= hi:
            continue
        part = logits[:, lo:hi]
        m = part.max(dim=1).values
        ms.append(m)
        ss.append(torch.exp(part - m[:, None]).sum(dim=1))
        v, i = topk_lowest_index(part, min(k, hi - lo))
        cand_v.append(v)
        cand_i.append(i + lo)
    M = torch.stack(ms, dim=1).max(dim=1).values
    S = sum(s * torch.exp(m - M) for m, s in zip(ms, ss))
    cv, ci = torch.cat(cand_v, dim=1), torch.cat(cand_i, dim=1)
    ci, by_id = torch.sort(ci, dim=1, stable=True)
    cv = torch.gather(cv, 1, by_id)
    cv, by_val = torch.sort(cv, dim=1, descending=True, stable=True)
    ci = torch.gather(ci, 1, by_val)
    return cv[:, :k], ci[:, :k].to(torch.int32), M + torch.log(S)


@pytest.mark.parametrize("N,V,card,k", [(16, 2560, "even", 5),
                                        (16, 2560, "even", 1),
                                        (2560, 2560, "tight", 8)])
def test_sweep_share_merge_matches_pallas_interpret(N, V, card, k):
    """The sweep's split of the vocab over cluster shares (``sweep_plan``)
    and its on-chip merge give the reference's ``_sweep_head_topk``
    (interpret mode), with exact ties on both sides of every share
    boundary."""
    shares, per = thead.sweep_plan(N, V, CLUSTERS[card])
    assert shares >= 2
    cuts = [c * per * thead.TILE_V for c in range(1, shares)]
    rng = np.random.default_rng(N + k)
    P = 16
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
    b = np.zeros((V,), np.float32)
    (jh, jw, jb), (th, tw, tb) = _both(h, pat, b)
    got = _share_merge(th @ tw + tb, k, shares, per)
    _assert_same(jhead._sweep_head_topk(jh, jw, jb, k=k,
                                        compute_dtype=jnp.float32,
                                        interpret=True), got)
    # Equal values rank by id whatever share holds them.
    assert int(got[1][1, 0]) == cuts[0] - 1
    assert int(got[1][4, 0]) == 5
