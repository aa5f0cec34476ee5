"""The port's EditNet (``captionkit_torch.models.editnet``) against
``captionkit.models.editnet`` on the CPU, on the same weights (JAX init,
carried over by the flat-name bridge) and the same numpy inputs.

Tolerances: fp32 atol 1e-4 (the same fp32 products, summed in other
orders, through a few layers). bf16 atol 1e-3: both sides round the same
operands to bf16 at the same places (context at encode, v_hat, every
product operand) and keep fp32 results, so they agree to fp32 rounding
unless a value lands within an ulp of a bf16 rounding boundary; 1e-3
leaves room for one such flip (measured here: agreement within 1e-5).
Top-k indices must be equal in both dtypes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionkit.models import get_model as jax_get_model
from captionkit.utils.config import ModelConfig as JaxModelConfig

from captionkit_torch.config import ModelConfig
from captionkit_torch.models import get_model
from captionkit_torch.params import editnet_params_from_numpy

SMALL = dict(vocab_size=150, emb_dim=16, hidden_dim=24, att_dim=8,
             feat_dim=12, num_regions=5, dropout=0.0)
ATOL = {"float32": 1e-4, "bfloat16": 1e-3}


def _models(dtype, **kw):
    jm = jax_get_model(JaxModelConfig(arch="editnet", compute_dtype=dtype,
                                      **SMALL, **kw))
    tm = get_model(ModelConfig(arch="editnet", compute_dtype=dtype,
                               **SMALL, **kw))
    jp = jm.init(jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    arrays = {"/".join(str(getattr(k, "name", k)) for k in path):
              np.asarray(leaf) for path, leaf in flat}
    return jm, jp, tm, editnet_params_from_numpy(arrays, "cpu")


def _inputs(B=3, T=6, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, SMALL["num_regions"],
                                 SMALL["feat_dim"])).astype(np.float32)
    ex = rng.integers(4, SMALL["vocab_size"], (B, T)).astype(np.int32)
    ln = np.array([T, 2, 4][:B], np.int32)
    return feats, ex, ln


def _encode(jm, jp, tm, tp, feats, ex, ln):
    jctx = jm.encode(jp, jnp.asarray(feats), jnp.asarray(ex), jnp.asarray(ln))
    tctx = tm.encode(tp, torch.from_numpy(feats), torch.from_numpy(ex).long(),
                     torch.from_numpy(ln).long())
    return jctx, tctx


def _close(j, t, atol):
    np.testing.assert_allclose(np.asarray(j, np.float32), t.float().numpy(),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches(dtype):
    jm, jp, tm, tp = _models(dtype)
    jctx, tctx = _encode(jm, jp, tm, tp, *_inputs())
    for f in ("features", "vis_keys", "v_mean", "att_zv", "enc_hs",
              "enc_cs", "scma_keys"):
        j, t = getattr(jctx, f), getattr(tctx, f)
        assert tuple(t.shape) == tuple(j.shape), f
        assert str(t.dtype).split(".")[-1] == str(j.dtype), f
        _close(j, t, ATOL[dtype])
    assert tctx.mask.tolist() == np.asarray(jctx.mask).tolist()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scma", ["soft", "hard"])
def test_step_and_step_topk_match(dtype, scma):
    K = 5
    jm, jp, tm, tp = _models(dtype, scma_select=scma)
    jctx, tctx = _encode(jm, jp, tm, tp, *_inputs())
    jctx = jm.beam_expand(jctx, K)
    tctx = tm.beam_expand(tctx, K)
    assert tuple(tctx.att_zv.shape) == (3 * K, 4 * SMALL["hidden_dim"])
    assert tuple(tctx.features.shape)[0] == 3  # keys stay per image
    jstate = jm.init_state(jp, jctx)
    tstate = tm.init_state(tp, tctx)
    tok = np.random.default_rng(1).integers(
        0, SMALL["vocab_size"], (3 * K,)).astype(np.int32)
    jtok, ttok = jnp.asarray(tok), torch.from_numpy(tok).long()
    atol = ATOL[dtype]

    # Two steps, so the second starts from a non-zero state.
    for _ in range(2):
        js1, jlogits = jm.step(jp, jctx, jstate, jtok)
        ts1, tlogits = tm.step(tp, tctx, tstate, ttok)
        _close(jlogits, tlogits, atol)
        for f in ("h_att", "c_att", "h_lang", "c_lang"):
            _close(getattr(js1, f), getattr(ts1, f), atol)

        jctx_k = jm.prepare_topk(jp, jctx, K)
        tctx_k = tm.prepare_topk(tp, tctx, K)
        js2, jv, ji, jl = jm.step_topk(jp, jctx_k, jstate, jtok, K)
        ts2, tv, ti, tl = tm.step_topk(tp, tctx_k, tstate, ttok, K)
        _close(jv, tv, atol)
        _close(jl, tl, atol)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        _close(js2.h_lang, ts2.h_lang, atol)
        jstate, tstate = js1, ts1
        jtok = jnp.asarray(np.asarray(jlogits).argmax(-1).astype(np.int32))
        ttok = tlogits.argmax(-1)
        assert ttok.tolist() == np.asarray(jtok).tolist()


def test_plain_head_config_matches_fused_head_on_cpu():
    """head_impl="xla" (plain full logits) and the default head give the
    same top-k on the CPU."""
    _, _, tm, tp = _models("float32")
    cfg = ModelConfig(arch="editnet", compute_dtype="float32",
                      head_impl="xla", **SMALL)
    plain = get_model(cfg)
    feats, ex, ln = _inputs()
    ctx = tm.encode(tp, torch.from_numpy(feats), torch.from_numpy(ex).long(),
                    torch.from_numpy(ln).long())
    state = tm.init_state(tp, ctx)
    tok = torch.arange(3)
    a = tm.step_topk(tp, tm.prepare_topk(tp, ctx, 5), state, tok, 5)
    b = plain.step_topk(tp, plain.prepare_topk(tp, ctx, 5), state, tok, 5)
    assert torch.equal(a[2], b[2])
    torch.testing.assert_close(a[1], b[1], atol=1e-6, rtol=0)


def test_unported_options_raise():
    """``cell_impl="wholestep"`` is ported: it builds, ``prepare_topk``
    gives it the fused-cell pack, and its ``step_topk`` answers on the
    CPU. The beam search's ``impl="backptr"`` history layout, ported
    since, gives the register layout's result."""
    from captionkit_torch.decode.beam import beam_search

    _, _, tm, tp = _models("float32")
    ws = get_model(ModelConfig(arch="editnet", compute_dtype="float32",
                               cell_impl="wholestep", **SMALL))
    assert ws.name == "editnet"
    feats, ex, ln = _inputs()
    ctx = ws.encode(tp, torch.from_numpy(feats), torch.from_numpy(ex).long(),
                    torch.from_numpy(ln).long())
    ctx_k = ws.prepare_topk(tp, ws.beam_expand(ctx, 2), 2)
    assert ctx_k.cell_pack is not None and ctx_k.head_w is not None
    _, vals, idx, lse = ws.step_topk(tp, ctx_k, ws.init_state(tp, ctx_k),
                                     torch.arange(6), 2)
    assert tuple(idx.shape) == (6, 2) and bool(torch.isfinite(lse).all())
    assert int(idx.max()) < SMALL["vocab_size"]
    bp, reg = (beam_search(tm, tp, ctx, beam_size=2, start_id=2, end_id=3,
                           impl=impl) for impl in ("backptr", "register"))
    for f in bp._fields:
        assert torch.equal(getattr(bp, f), getattr(reg, f)), f
    # The fused cells, the int8 head, the thresh extraction and DCNet build.
    for kw in ({"cell_impl": "pallas"}, {"head_quant": "int8"},
               {"head_extract": "thresh"}):
        assert get_model(ModelConfig(**kw)).name == "editnet"
    assert get_model(ModelConfig(arch="dcnet")).name == "dcnet"


@pytest.mark.parametrize("arch", ["editnet", "dcnet"])
def test_init_defaults_to_the_card(arch):
    """``ModelDef.init(seed)`` builds the weights on the card and raises
    where there is none; the CPU is used only when the caller names it."""
    model = get_model(dataclasses.replace(ModelConfig(arch=arch), **SMALL))
    if torch.cuda.is_available():
        assert model.init(0).fc_w.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            model.init(0)
    params = model.init(0, "cpu")
    assert params.fc_w.device.type == "cpu"
    assert tuple(params.fc_w.shape) == (SMALL["hidden_dim"],
                                        SMALL["vocab_size"])
