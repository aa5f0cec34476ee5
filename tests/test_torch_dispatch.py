"""The port's cell dispatch (``captionkit_torch.nn.dispatch``) and its cell
kernels' plain versions (``kernels/lstm.py``, ``kernels/attention.py``)
against the JAX package's fused cells (``captionkit.ops.lstm``,
``captionkit.ops.attention``) on the CPU, where the JAX kernels run in
interpret mode (as ``tests/test_ops_pallas.py`` runs them) and the port's
wrappers run their plain versions. Inputs come from numpy.

Tolerances: at fp32 h and c within 2e-5, the weights within 2e-5 and the
context within 3e-4 (the reference's own bars for its fused cells against
its jnp cells: the same products summed in another order). At bf16 both
sides round the same operands to bf16 and sum in fp32: h and c within
1e-4, the weights within 1e-4, the context within 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionkit.models import get_model as jax_get_model
from captionkit.nn.attention import AdditiveAttentionParams as JaxAttParams
from captionkit.nn.cells import CopyLSTMParams as JaxCopyParams
from captionkit.nn.cells import LSTMParams as JaxLSTMParams
from captionkit.ops.attention import fused_additive_attention as jax_attn
from captionkit.ops.lstm import fused_copy_lstm_cell as jax_copy
from captionkit.ops.lstm import fused_lstm_cell as jax_lstm
from captionkit.utils.config import ModelConfig as JaxModelConfig

from captionkit_torch import nn as tnn
from captionkit_torch.config import ModelConfig
from captionkit_torch.kernels import attention as tattn
from captionkit_torch.kernels import lstm as tlstm
from captionkit_torch.models import dcnet as t_dcnet
from captionkit_torch.models import editnet as t_editnet
from captionkit_torch.models import get_model
from captionkit_torch.nn.attention import AdditiveAttentionParams
from captionkit_torch.nn.cells import CopyLSTMParams, LSTMParams
from captionkit_torch.params import (
    dcnet_params_from_numpy,
    editnet_params_from_numpy,
)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CELL_ATOL = {"float32": 2e-5, "bfloat16": 1e-4}
W_ATOL = {"float32": 2e-5, "bfloat16": 1e-4}
CTX_ATOL = {"float32": 3e-4, "bfloat16": 1e-3}

# (B, D, H): the reference's shape classes (tests/test_ops_pallas.py)
SHAPES = [(8, 128, 128), (5, 48, 72), (130, 256, 128), (64, 3072, 1024)]


def test_getters_default_to_the_plain_cells():
    assert tnn.get_lstm_cell_fn() is tnn.lstm_cell
    assert tnn.get_copy_lstm_cell_fn() is tnn.copy_lstm_cell
    assert tnn.get_attention_fn() is tnn.additive_attention
    assert tnn.get_lstm_cell_fn(True) is tlstm.fused_lstm_cell
    assert tnn.get_copy_lstm_cell_fn(True) is tlstm.fused_copy_lstm_cell
    assert tnn.get_attention_fn(True) is tattn.fused_additive_attention


def _lstm_arrays(D, H, seed, copy):
    rng = np.random.default_rng(seed)
    s = H ** -0.5

    def u(*shape):
        return rng.uniform(-s, s, shape).astype(np.float32)

    base = dict(wx=u(D, 4 * H), wh=u(H, 4 * H), b=u(4 * H))
    extra = dict(wrx=u(D, H), wrh=u(H, H), wrc=u(H, H), br=u(H)) \
        if copy else {}
    return base, extra


def _lstm_inputs(B, D, H, seed):
    rng = np.random.default_rng(seed + 1)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, D), (B, H), (B, H), (B, H))]


def _close(got, want, atol, msg=""):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               atol=atol, rtol=0, err_msg=msg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,D,H", SHAPES)
def test_lstm_cell_matches_jax_fused(B, D, H, dtype):
    base, _ = _lstm_arrays(D, H, 0, False)
    x, h, c, _ = _lstm_inputs(B, D, H, 0)
    j = jax_lstm(JaxLSTMParams(**{k: jnp.asarray(v) for k, v in base.items()}),
                 jnp.asarray(x), jnp.asarray(h), jnp.asarray(c),
                 compute_dtype=JDT[dtype], interpret=True)
    fn = tnn.get_lstm_cell_fn(use_pallas=True)
    t = fn(LSTMParams(**{k: torch.from_numpy(v) for k, v in base.items()}),
           torch.from_numpy(x), torch.from_numpy(h), torch.from_numpy(c),
           compute_dtype=TDT[dtype])
    for name, got, want in zip(("h", "c"), t, j):
        assert tuple(got.shape) == (B, H)
        _close(got, want, CELL_ATOL[dtype], name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,D,H", SHAPES[:3])
def test_copy_lstm_cell_matches_jax_fused(B, D, H, dtype):
    base, extra = _lstm_arrays(D, H, 2, True)
    x, h, c, cs = _lstm_inputs(B, D, H, 2)
    jp = JaxCopyParams(
        base=JaxLSTMParams(**{k: jnp.asarray(v) for k, v in base.items()}),
        **{k: jnp.asarray(v) for k, v in extra.items()})
    j = jax_copy(jp, jnp.asarray(x), jnp.asarray(h), jnp.asarray(c),
                 jnp.asarray(cs), compute_dtype=JDT[dtype], interpret=True)
    tp = CopyLSTMParams(
        base=LSTMParams(**{k: torch.from_numpy(v) for k, v in base.items()}),
        **{k: torch.from_numpy(v) for k, v in extra.items()})
    fn = tnn.get_copy_lstm_cell_fn(use_pallas=True)
    t = fn(tp, *(torch.from_numpy(a) for a in (x, h, c, cs)),
           compute_dtype=TDT[dtype])
    for name, got, want in zip(("h", "c"), t, j):
        _close(got, want, CELL_ATOL[dtype], name)
    # The padded pack is built once per parameter object and dtype.
    pack = tp.cache[("kernel_pack", TDT[dtype])]
    fn(tp, *(torch.from_numpy(a) for a in (x, h, c, cs)),
       compute_dtype=TDT[dtype])
    assert tp.cache[("kernel_pack", TDT[dtype])] is pack


def test_lstm_wrappers_take_the_plain_cells_packed_weights():
    """``packed=`` (the plain cells' precomputed weights) gives the same
    result as packing here; at aligned widths it is used as it is."""
    base, extra = _lstm_arrays(64, 32, 3, True)
    x, h, c, cs = (torch.from_numpy(a) for a in _lstm_inputs(4, 64, 32, 3))
    tp = CopyLSTMParams(
        base=LSTMParams(**{k: torch.from_numpy(v) for k, v in base.items()}),
        **{k: torch.from_numpy(v) for k, v in extra.items()})
    dt = torch.bfloat16
    packed = tnn.pack_copy_lstm(tp, dt)
    a = tlstm.fused_copy_lstm_cell(tp, x, h, c, cs, compute_dtype=dt,
                                   packed=packed)
    b = tlstm.fused_copy_lstm_cell(tp, x, h, c, cs, compute_dtype=dt)
    plain = tnn.copy_lstm_cell(tp, x, h, c, cs, compute_dtype=dt,
                               packed=packed)
    for g, w, p in zip(a, b, plain):
        assert torch.equal(g, w)
        torch.testing.assert_close(g, p, atol=1e-6, rtol=0)
    assert tlstm.copy_lstm_cell_pack(tp, dt, packed).w is packed[0]
    lp = tp.base
    one = tlstm.fused_lstm_cell(lp, x, h, c, compute_dtype=dt,
                                packed=tnn.pack_lstm(lp, dt))
    for g, p in zip(one, tnn.lstm_cell(lp, x, h, c, compute_dtype=dt)):
        torch.testing.assert_close(g, p, atol=1e-6, rtol=0)


def _attention_case(B, N, A, V, Q, seed=4, masked=True):
    rng = np.random.default_rng(seed)
    arrays = dict(w_enc=rng.uniform(-1, 1, (V, A)).astype(np.float32)
                  * V ** -0.5,
                  w_q=rng.uniform(-1, 1, (Q, A)).astype(np.float32)
                  * Q ** -0.5,
                  v=rng.uniform(-1, 1, (A,)).astype(np.float32) * A ** -0.5,
                  b=rng.uniform(-0.1, 0.1, (A,)).astype(np.float32))
    values = rng.standard_normal((B, N, V)).astype(np.float32)
    keys = values @ arrays["w_enc"]
    query = rng.standard_normal((B, Q)).astype(np.float32)
    mask = None
    if masked:
        lengths = rng.integers(1, N + 1, (B,))
        mask = np.arange(N)[None, :] < lengths[:, None]
    return arrays, keys, values, query, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,A,V,Q,masked", [
    (8, 36, 512, 2048, 1024, True),  # visual attention shape class
    (6, 22, 64, 96, 96, True),       # SCMA shape class (unaligned)
    (4, 10, 8, 32, 16, False),       # no mask
])
def test_attention_matches_jax_fused(B, N, A, V, Q, masked, dtype):
    arrays, keys, values, query, mask = _attention_case(B, N, A, V, Q,
                                                        masked=masked)
    jp = JaxAttParams(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jmask = None if mask is None else jnp.asarray(mask)
    # The models keep keys and values in the compute dtype.
    jk = jnp.asarray(keys).astype(JDT[dtype])
    jv = jnp.asarray(values).astype(JDT[dtype])
    j_ctx, j_w = jax_attn(jp, jk, jv, jnp.asarray(query), jmask,
                          compute_dtype=JDT[dtype], interpret=True)
    tp = AdditiveAttentionParams(
        **{k: torch.from_numpy(v) for k, v in arrays.items()})
    fn = tnn.get_attention_fn(use_pallas=True)
    tk = torch.from_numpy(keys).to(TDT[dtype])
    tv = torch.from_numpy(values).to(TDT[dtype])
    t_ctx, t_w = fn(tp, tk, tv, torch.from_numpy(query),
                    None if mask is None else torch.from_numpy(mask),
                    compute_dtype=TDT[dtype])
    assert t_w.dtype == torch.float32 and t_ctx.dtype == torch.float32
    _close(t_w, np.asarray(j_w, np.float32), W_ATOL[dtype], "weights")
    _close(t_ctx, np.asarray(j_ctx, np.float32), CTX_ATOL[dtype], "ctx")
    if mask is not None:
        assert bool((t_w[~torch.from_numpy(mask)] == 0).all())


def test_attention_mask_is_read_as_a_prefix_count():
    """The kernel reduces the mask to its valid count: a non-prefix mask
    reads as the prefix of the same length, as the TPU kernel's."""
    arrays, keys, values, query, _ = _attention_case(2, 6, 8, 16, 8)
    tp = AdditiveAttentionParams(
        **{k: torch.from_numpy(v) for k, v in arrays.items()})
    holes = torch.tensor([[True, False, True, False, False, False]] * 2)
    prefix = torch.tensor([[True, True, False, False, False, False]] * 2)
    args = (tp, torch.from_numpy(keys), torch.from_numpy(values),
            torch.from_numpy(query))
    a = tattn.fused_additive_attention(*args, holes)
    b = tattn.fused_additive_attention(*args, prefix)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _model_pair(arch, **over):
    kw = dict(vocab_size=40, emb_dim=16, hidden_dim=24, att_dim=8,
              feat_dim=12, num_regions=5, dropout=0.0,
              compute_dtype="float32", arch=arch, **over)
    jm, tm = jax_get_model(JaxModelConfig(**kw)), get_model(ModelConfig(**kw))
    jp = jm.init(jax.random.PRNGKey(1))
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    arrays = {"/".join(str(getattr(k, "name", k)) for k in path):
              np.asarray(leaf) for path, leaf in flat if leaf is not None}
    bridge = (editnet_params_from_numpy if arch == "editnet"
              else dcnet_params_from_numpy)
    return jm, jp, tm, bridge(arrays, "cpu"), ModelConfig(**kw)


@pytest.mark.parametrize("arch,over", [("editnet", {}), ("dcnet", {}),
                                       ("dcnet", {"dcnet_use_visual": True})])
def test_model_step_through_the_dispatch_kernels(arch, over, monkeypatch):
    """The models ask the getters at the reference's call sites: with
    ``use_pallas=True`` the step runs the kernel wrappers (each call site
    once a step) and, at fp32, gives the JAX step's logits within 1e-4
    (the fused attention's weights enter its context unrounded, which at
    fp32 is the plain attention's function too)."""
    jm, jp, tm, tp, cfg = _model_pair(arch, **over)
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((3, 5, 12)).astype(np.float32)
    ex = rng.integers(4, 40, (3, 6)).astype(np.int32)
    ln = np.array([6, 2, 4], np.int32)
    jctx = jm.encode(jp, jnp.asarray(feats), jnp.asarray(ex), jnp.asarray(ln))
    tctx = tm.encode(tp, torch.from_numpy(feats), torch.from_numpy(ex).long(),
                     torch.from_numpy(ln).long())
    calls = []
    for name in ("get_lstm_cell_fn", "get_copy_lstm_cell_fn",
                 "get_attention_fn"):
        real = getattr(tnn.dispatch, name)

        def spy(use_pallas=False, _real=real, _name=name):
            fn = _real(use_pallas)

            def wrapped(*a, **k):
                calls.append((_name, use_pallas))
                return fn(*a, **k)
            return wrapped
        for mod in (t_editnet, t_dcnet):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, spy)
    mod = t_editnet if arch == "editnet" else t_dcnet
    tok = np.array([2, 7, 9], np.int32)
    js, jl = jm.step(jp, jctx, jm.init_state(jp, jctx), jnp.asarray(tok),
                     None, False)
    ts = tm.init_state(tp, tctx)
    _, tl = mod.step(tp, cfg, tctx, ts, torch.from_numpy(tok).long(),
                     use_pallas=True)
    _close(tl, np.asarray(jl), 1e-4, "logits")
    assert calls and all(p for _, p in calls)
    want = ({"get_copy_lstm_cell_fn": 1, "get_attention_fn": 2}
            if arch == "editnet" else
            {"get_lstm_cell_fn": 1,
             "get_attention_fn": 2 if over else 1})
    got = {}
    for name, _ in calls:
        got[name] = got.get(name, 0) + 1
    assert got == want
    calls.clear()
    _, tl0 = mod.step(tp, cfg, tctx, ts, torch.from_numpy(tok).long())
    assert calls and not any(p for _, p in calls)
    torch.testing.assert_close(tl0, tl, atol=1e-4, rtol=0)


def test_cpu_tensors_count_no_launch():
    base, _ = _lstm_arrays(32, 32, 0, False)
    tp = LSTMParams(**{k: torch.from_numpy(v) for k, v in base.items()})
    x = torch.zeros((2, 32))
    before = (tlstm.fused_lstm_cell.launches,
              tattn.fused_additive_attention.launches)
    tlstm.fused_lstm_cell(tp, x, x, x, compute_dtype=torch.bfloat16)
    ap = AdditiveAttentionParams(w_enc=torch.zeros((4, 8)),
                                 w_q=torch.zeros((32, 8)),
                                 v=torch.zeros(8), b=torch.zeros(8))
    tattn.fused_additive_attention(ap, torch.zeros((2, 3, 8)),
                                   torch.zeros((2, 3, 4)), x)
    assert (tlstm.fused_lstm_cell.launches,
            tattn.fused_additive_attention.launches) == before
    assert dataclasses.fields(LSTMParams)[-1].name == "cache"
