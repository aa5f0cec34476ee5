"""The port's vocab head (``captionkit_torch.kernels.head``) against
``captionkit.ops.head`` on the CPU (the CUDA kernel against its plain
version on a card is in test_torch_card.py).

On the CPU ``fused_head_topk`` takes its plain version; the JAX side runs
the Pallas kernel in interpret mode, as its own tests do. Indices must be
equal; values and log-sum-exp within atol 1e-5 (fp32 sums of the same
products in different orders). The tie patterns are exact in every dtype.
"""

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


def test_adversarial_duplicates():
    h, w, b = _adversarial()
    (jh, jw, jb), (th, tw, tb) = _both(h, w, b)
    got = thead.fused_head_topk(th, tw, tb, k=5)
    _assert_same(jhead.fused_head_topk(jh, jw, jb, k=5, interpret=True,
                                       tiles=(8, 128)), got, atol=1e-6)
    assert got[1][0].tolist() == [7, 130, 300, 12, 260]
    assert got[1][4].tolist()[:3] == [10, 200, 210]


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
