"""The port's cells, attention and SCMA against ``captionkit.nn`` on the
CPU. Inputs come from one numpy generator and go to both sides.

Tolerance: fp32 throughout, atol 1e-5 — both sides form the same fp32
products and sums, in orders that may differ by a few ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionkit.nn import attention as jatt
from captionkit.nn import cells as jcells

from captionkit_torch.nn import attention as tatt
from captionkit_torch.nn import cells as tcells
from captionkit_torch.nn.masking import NEG_INF, length_mask
from captionkit_torch.nn.topk import topk_lowest_index

ATOL = 1e-5


def _pair(*arrays):
    """numpy arrays -> (jax arrays, torch tensors)."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=atol, rtol=0)


def _lstm(rng, d, h):
    a = [rng.uniform(-0.3, 0.3, s).astype(np.float32)
         for s in ((d, 4 * h), (h, 4 * h), (4 * h,))]
    (j, t) = _pair(*a)
    return jcells.LSTMParams(*j), tcells.LSTMParams(*t)


def _attention(rng, e, q, a):
    arrs = [rng.uniform(-0.5, 0.5, s).astype(np.float32)
            for s in ((e, a), (q, a), (a,), (a,))]
    (j, t) = _pair(*arrs)
    return jatt.AdditiveAttentionParams(*j), tatt.AdditiveAttentionParams(*t)


def test_lstm_cell_and_copy_lstm_cell():
    rng = np.random.default_rng(0)
    B, D, H = 6, 10, 8
    jp, tp = _lstm(rng, D, H)
    (jx, jh, jc, js), (tx, th, tc, ts) = _pair(
        *(rng.standard_normal(s).astype(np.float32)
          for s in ((B, D), (B, H), (B, H), (B, H))))
    for j, t in zip(jcells.lstm_cell(jp, jx, jh, jc),
                    tcells.lstm_cell(tp, tx, th, tc)):
        _close(j, t)

    copy_w = [rng.uniform(-0.3, 0.3, s).astype(np.float32)
              for s in ((D, H), (H, H), (H, H), (H,))]
    (jw, tw) = _pair(*copy_w)
    jcp = jcells.CopyLSTMParams(jp, *jw)
    tcp = tcells.CopyLSTMParams(tp, *tw)
    for j, t in zip(jcells.copy_lstm_cell(jcp, jx, jh, jc, js),
                    tcells.copy_lstm_cell(tcp, tx, th, tc, ts)):
        _close(j, t)
    # The pre-packed kernels give the same step.
    packed = tcells.pack_copy_lstm(tcp, torch.float32)
    for j, t in zip(jcells.copy_lstm_cell(jcp, jx, jh, jc, js),
                    tcells.copy_lstm_cell(tcp, tx, th, tc, ts,
                                          packed=packed)):
        _close(j, t)


def test_lstm_encode_ragged_lengths_freeze_padding():
    rng = np.random.default_rng(1)
    B, T, E, H = 5, 7, 6, 8
    jp, tp = _lstm(rng, E, H)
    emb = rng.standard_normal((B, T, E)).astype(np.float32)
    lens = np.array([7, 1, 4, 2, 5], np.int32)
    (je, jl), (te, tl) = _pair(emb, lens)
    jhs, jcs = jcells.lstm_encode(jp, je, jl)
    ths, tcs = tcells.lstm_encode(tp, te, tl.long())
    _close(jhs, ths)
    _close(jcs, tcs)
    # Padding positions hold the last valid state.
    for b, n in enumerate(lens):
        assert torch.equal(ths[b, n:], ths[b, n - 1:n].expand(T - n, H))


@pytest.mark.parametrize("G", [1, 5])
@pytest.mark.parametrize("masked", [False, True])
def test_additive_attention_grouped(G, masked):
    rng = np.random.default_rng(10 * G + masked)
    B, N, A, V, Q = 3, 6, 8, 10, 7
    jp, tp = _attention(rng, V, Q, A)
    keys = rng.standard_normal((B, N, A)).astype(np.float32)
    values = rng.standard_normal((B, N, V)).astype(np.float32)
    query = rng.standard_normal((B * G, Q)).astype(np.float32)
    lens = np.array([6, 2, 4], np.int32)
    (jk, jv, jq), (tk, tv, tq) = _pair(keys, values, query)
    jm = jnp.arange(N)[None, :] < jnp.asarray(lens)[:, None] if masked \
        else None
    tm = length_mask(torch.from_numpy(lens), N) if masked else None
    jctx, jw = jatt.additive_attention(jp, jk, jv, jq, jm)
    tctx, tw = tatt.additive_attention(tp, tk, tv, tq, tm)
    assert tuple(tctx.shape) == (B * G, V)
    _close(jctx, tctx)
    _close(jw, tw)
    if masked:  # masked positions get no weight
        w = tw.reshape(B, G, N)
        assert float(w[1, :, 2:].abs().max()) == 0.0
    # project_keys: [B, N, enc] -> [B, N, A]
    _close(jatt.project_keys(jp, jv), tatt.project_keys(tp, tv))


@pytest.mark.parametrize("mode", ["soft", "hard"])
@pytest.mark.parametrize("G", [1, 5])
def test_scma_select(mode, G):
    rng = np.random.default_rng(3 + G)
    B, T, A, H = 2, 5, 8, 6
    jp, tp = _attention(rng, H, H, A)
    keys = rng.standard_normal((B, T, A)).astype(np.float32)
    mem = rng.standard_normal((B, T, H)).astype(np.float32)
    query = rng.standard_normal((B * G, H)).astype(np.float32)
    lens = np.array([5, 3], np.int32)
    (jk, jmem, jq), (tk, tmem, tq) = _pair(keys, mem, query)
    jm = jnp.arange(T)[None, :] < jnp.asarray(lens)[:, None]
    tm = length_mask(torch.from_numpy(lens), T)
    jc, jw = jatt.scma_select(jp, jk, jmem, jq, jm, mode=mode)
    tc, tw = tatt.scma_select(tp, tk, tmem, tq, tm, mode=mode)
    _close(jc, tc)
    _close(jw, tw)
    if mode == "hard":  # the gathered memory row itself
        idx = tw.argmax(-1).reshape(B, G)
        for b in range(B):
            for g in range(G):
                torch.testing.assert_close(
                    tc[b * G + g], tmem[b, idx[b, g]], atol=ATOL, rtol=0)


def test_bf16_products_round_operands_and_keep_fp32_results():
    """mm(a, b, bf16) is jnp.dot(a.astype(bf16), b.astype(bf16),
    preferred_element_type=f32): operands rounded, fp32 result."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((4, 3, 16)).astype(np.float32)
    b = rng.standard_normal((16, 5)).astype(np.float32)
    ref = jnp.einsum("bte,ef->btf", jnp.asarray(a).astype(jnp.bfloat16),
                     jnp.asarray(b).astype(jnp.bfloat16),
                     preferred_element_type=jnp.float32)
    got = tcells.mm(torch.from_numpy(a), torch.from_numpy(b), torch.bfloat16)
    assert got.dtype == torch.float32
    _close(ref, got)
    assert tcells.matmul_route("cpu") == \
        "float32 product of bf16-rounded operands"


def test_masking_constants():
    assert NEG_INF == -1e9
    m = length_mask(torch.tensor([0, 2, 3]), 3)
    assert m.tolist() == [[False] * 3, [True, True, False], [True] * 3]


def test_topk_lowest_index_on_plateaus():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0],
                      [NEG_INF] * 5,
                      [0.0, NEG_INF, 0.0, NEG_INF, 0.0]])
    vals, idx = topk_lowest_index(x, 3)
    assert idx.tolist() == [[1, 2, 4], [0, 1, 2], [0, 2, 4]]
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    assert idx.tolist() == np.asarray(ref_i).tolist()
    _close(ref_v, vals)
