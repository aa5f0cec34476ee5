"""The port's int8 vocab head (``head_quant="int8"``) against
``captionkit.ops.head`` and the JAX beam search on the CPU (the CUDA
kernel against its plain version on a card is in test_torch_card.py).

On the CPU ``fused_head_topk_int8`` takes its plain version,
``reference_head_topk_int8``; the JAX side runs the Pallas kernel in
interpret mode and its XLA twin. Both quantize with the same arithmetic
(IEEE division, round half to even), so the quantized weights and rows
are equal; the int8 sums are exact on both sides. Indices must be equal;
values within atol 2e-5 and the log-sum-exp within 2e-4, the reference's
own bars for its int8 kernel (``tests/test_head_quant.py``). The port pads
the vocab to 128 columns, the reference to its own tile: the first V
columns are compared, the padding checked on its own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionkit.decode import beam_search as jax_beam_search
from captionkit.models import get_model as jax_get_model
from captionkit.ops import head as jhead
from captionkit.utils.config import ModelConfig as JaxModelConfig

from captionkit_torch import params as bridge
from captionkit_torch.config import ModelConfig
from captionkit_torch.decode.beam import beam_search
from captionkit_torch.kernels import head as thead
from captionkit_torch.models import get_model

SHAPES = [(8, 16, 40, 5), (13, 32, 257, 3), (64, 64, 1000, 5)]


def _inputs(n, h, v, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, h)).astype(np.float32),
            rng.standard_normal((h, v)).astype(np.float32),
            rng.standard_normal((v,)).astype(np.float32))


def _quantized(x, w, b, k):
    """((JAX w_q, scale, b_p), (port w_q, scale, b_p)) of one head."""
    j = jhead.quantize_head(jnp.asarray(w), jnp.asarray(b), n_rows=x.shape[0],
                            k=k)
    t = thead.quantize_head(torch.from_numpy(w), torch.from_numpy(b))
    return j, t


@pytest.mark.parametrize("n,h,v,k", SHAPES)
def test_quantize_head_matches_jax(n, h, v, k):
    x, w, b = _inputs(n, h, v)
    (jw, js, jb), (tw, ts, tb) = _quantized(x, w, b, k)
    assert tw.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tw[:, :v].numpy(), np.asarray(jw)[:, :v])
    np.testing.assert_array_equal(ts[:v].numpy(), np.asarray(js)[:v])
    np.testing.assert_array_equal(tb[:v].numpy(), np.asarray(jb)[:v])
    # The port's padding: 128-column tiles, weight 0, scale 1, bias -1e30.
    vp = tw.shape[1]
    assert vp % thead.TILE_V == 0 and vp - v < thead.TILE_V
    assert bool((tw[:, v:] == 0).all()) and bool((ts[v:] == 1).all())
    assert bool((tb[v:] == thead.HEAD_PAD).all())


def test_quantize_head_scale_floor_and_extremes():
    """scale = max|w| / 127: the largest magnitude lands on +-127; a
    column of zeros takes the 1e-8 floor and quantizes to 0."""
    w = np.zeros((4, 3), np.float32)
    w[:, 0] = [1.0, -0.5, 0.25, 2.0]
    w[:, 2] = [-3.0, 1.5, 0.0, 3.0]
    b = np.zeros((3,), np.float32)
    tw, ts, _ = thead.quantize_head(torch.from_numpy(w), torch.from_numpy(b))
    jw, js, _ = jhead.quantize_head(jnp.asarray(w), jnp.asarray(b),
                                    n_rows=4, k=1)
    np.testing.assert_array_equal(tw[:, :3].numpy(), np.asarray(jw)[:, :3])
    np.testing.assert_array_equal(ts[:3].numpy(), np.asarray(js)[:3])
    assert int(tw[3, 0]) == 127 and int(tw[0, 2]) == -127
    assert int(tw[3, 2]) == 127 and tw[:, 1].tolist() == [0] * 4
    assert float(ts[1]) == np.float32(np.float32(1e-8) / np.float32(127))


@pytest.mark.parametrize("n,h,v,k", SHAPES)
def test_quantize_rows_and_logits_match_jax(n, h, v, k):
    x, w, b = _inputs(n, h, v, seed=3)
    (jw, js, jb), (tw, ts, tb) = _quantized(x, w, b, k)
    jq, jsh = jhead._quantize_rows(jnp.asarray(x))
    tq, tsh = thead.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tsh.numpy(), np.asarray(jsh))
    jl = np.asarray(jhead.quantized_head_logits(jnp.asarray(x), jw, js, jb))
    tl = thead.quantized_head_logits(torch.from_numpy(x), tw, ts, tb)
    np.testing.assert_allclose(tl[:, :v].numpy(), jl[:, :v], atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("extract", ["mask", "thresh"])
@pytest.mark.parametrize("n,h,v,k", SHAPES)
def test_int8_head_matches_jax(n, h, v, k, extract):
    x, w, b = _inputs(n, h, v)
    (jw, js, jb), (tw, ts, tb) = _quantized(x, w, b, k)
    th = torch.from_numpy(x)
    before = thead.fused_head_topk_int8.launches
    got = thead.fused_head_topk_int8(th, tw, ts, tb, k=k, extract=extract)
    assert thead.fused_head_topk_int8.launches == before  # CPU: no kernel
    assert got[1].dtype == torch.int32
    for want in (jhead.fused_head_topk_int8(jnp.asarray(x), jw, js, jb, k=k,
                                            interpret=True, extract=extract),
                 jhead.xla_head_topk_int8(jnp.asarray(x), jw, js, jb, k=k)):
        jv, ji, jl = (np.asarray(a) for a in want)
        np.testing.assert_array_equal(got[1].numpy(), ji)
        np.testing.assert_allclose(got[0].numpy(), jv, atol=2e-5, rtol=0)
        np.testing.assert_allclose(got[2].numpy(), jl, atol=2e-4, rtol=0)
    # The plain version is the wrapper's CPU path, bit for bit.
    ref = thead.reference_head_topk_int8(th, tw, ts, tb, k)
    assert all(torch.equal(a, r) for a, r in zip(got, ref))


def test_int8_tie_break_lowest_index():
    """Identical quantized columns resolve to the lowest vocab id, as
    lax.top_k does (tests/test_head_quant.py)."""
    n, h, v, k = 8, 16, 130, 3
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, h)).astype(np.float32)
    w = np.repeat(rng.standard_normal((h, 1)).astype(np.float32), v, axis=1)
    b = np.zeros((v,), np.float32)
    (jw, js, jb), (tw, ts, tb) = _quantized(x, w, b, k)
    _, idx, _ = thead.fused_head_topk_int8(torch.from_numpy(x), tw, ts, tb,
                                           k=k, extract="thresh")
    assert idx.tolist() == [[0, 1, 2]] * n
    _, jidx, _ = jhead.fused_head_topk_int8(jnp.asarray(x), jw, js, jb, k=k,
                                            interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_int8_head_rejects_unknown_extract():
    x, w, b = _inputs(8, 16, 40)
    tw, ts, tb = thead.quantize_head(torch.from_numpy(w), torch.from_numpy(b))
    with pytest.raises(ValueError, match="extract"):
        thead.fused_head_topk_int8(torch.from_numpy(x), tw, ts, tb, k=3,
                                   extract="sort")


# -- beam decode on the int8 head ---------------------------------------------

DIMS = dict(vocab_size=50, emb_dim=12, hidden_dim=16, att_dim=8,
            feat_dim=10, num_regions=4, dropout=0.0, compute_dtype="float32")


def _flat(jp):
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    return {"/".join(str(getattr(p, "name", p)) for p in path):
            np.asarray(leaf) for path, leaf in flat if leaf is not None}


def _decode_both(arch, k, seed=0, batch=6, max_len=10, **kw):
    """Tokens of the JAX beam search and the port's on the same weights
    (JAX init through the flat-name bridge) and inputs."""
    jcfg = JaxModelConfig(arch=arch, head_quant="int8", **DIMS, **kw)
    tcfg = ModelConfig(arch=arch, head_quant="int8", **DIMS, **kw)
    jm, tm = jax_get_model(jcfg), get_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(7))
    from_numpy = (bridge.editnet_params_from_numpy if arch == "editnet"
                  else bridge.dcnet_params_from_numpy)
    tp = from_numpy(_flat(jp), "cpu")
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((batch, 4, 10)).astype(np.float32)
    ex = rng.integers(4, 48, (batch, 7)).astype(np.int32)
    ln = rng.integers(2, 8, (batch,)).astype(np.int32)
    jctx = jm.encode(jp, None if arch == "dcnet" else jnp.asarray(feats),
                     jnp.asarray(ex), jnp.asarray(ln))
    jt = np.asarray(jax_beam_search(jm, jp, jctx, beam_size=k, start_id=1,
                                    end_id=2, max_len=max_len).tokens)
    tctx = tm.encode(tp, torch.from_numpy(feats), torch.from_numpy(ex).long(),
                     torch.from_numpy(ln).long())
    before = thead.fused_head_topk_int8.launches
    tt = beam_search(tm, tp, tctx, beam_size=k, start_id=1, end_id=2,
                     max_len=max_len).tokens.numpy()
    assert thead.fused_head_topk_int8.launches == before  # CPU: no kernel
    return jt, tt


@pytest.mark.filterwarnings("ignore:head_quant='int8' with arch='dcnet'")
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("arch", ["editnet", "dcnet"])
def test_int8_beam_decode_matches_jax(arch, k):
    jt, tt = _decode_both(arch, k)
    np.testing.assert_array_equal(tt, jt)


@pytest.mark.filterwarnings("ignore:head_quant='int8' with arch='dcnet'")
@pytest.mark.parametrize("arch", ["editnet", "dcnet"])
def test_int8_with_fused_cells_matches_jax(arch):
    """head_quant="int8" with cell_impl="pallas" (the analog of the
    reference's test_int8_composes_with_fused_cells): the port's fused
    cells feed the int8 head the same captions as JAX's."""
    jt, tt = _decode_both(arch, 3, seed=1, cell_impl="pallas")
    np.testing.assert_array_equal(tt, jt)


def test_int8_plain_dispatch_matches_kernel_dispatch():
    """head_impl="xla" under int8 runs the plain int8 head; on the CPU
    the kernel dispatch takes the same plain version, so the step's
    outputs are equal, and prepare_topk quantized the head once."""
    tm = get_model(ModelConfig(arch="editnet", head_quant="int8", **DIMS))
    plain = get_model(ModelConfig(arch="editnet", head_quant="int8",
                                  head_impl="xla", **DIMS))
    tp = tm.init(0, "cpu")
    rng = np.random.default_rng(2)
    ctx = tm.encode(tp, torch.from_numpy(
        rng.standard_normal((2, 4, 10)).astype(np.float32)),
        torch.from_numpy(rng.integers(4, 48, (2, 7))),
        torch.tensor([7, 3]))
    ctx_k = tm.prepare_topk(tp, tm.beam_expand(ctx, 3), 3)
    assert ctx_k.head_w.dtype == torch.int8
    assert ctx_k.head_scale is not None
    state = tm.init_state(tp, ctx_k)
    tok = torch.arange(6)
    a = tm.step_topk(tp, ctx_k, state, tok, 3)
    b = plain.step_topk(tp, plain.prepare_topk(tp, ctx_k.replace(
        head_w=None, head_b=None, head_scale=None), 3), state, tok, 3)
    for x, y in zip(a[1:], b[1:]):
        assert torch.equal(x, y)
    # Without prepare_topk the head is quantized inline, to the same.
    c = tm.step_topk(tp, dataclasses.replace(ctx_k, head_w=None, head_b=None,
                                             head_scale=None), state, tok, 3)
    for x, y in zip(a[1:], c[1:]):
        assert torch.equal(x, y)
