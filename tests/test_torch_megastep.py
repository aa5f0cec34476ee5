"""The port's fused decode-step cells (``captionkit_torch.kernels.megastep``)
against ``captionkit.ops.megastep`` on the CPU, where the port's wrappers
run their plain versions and the JAX package runs its Pallas kernels in
interpret mode (as ``tests/test_megastep.py`` does). Weights are the JAX
``init``, carried over by the flat-name bridge; inputs come from numpy.

Dims are small and unaligned (E=12, H=16, A=8, F=10, R=4), so every
padding path of both packs runs. Tolerances: fp32 2e-5 (the reference's
own bar for its fused step against its jnp step: the same products summed
in another order); bf16 1e-3 (both sides round the same operands at the
same places; a value within an ulp of a bf16 rounding boundary may round
the other way).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionkit.decode.beam import beam_search as jax_beam_search
from captionkit.models import dcnet as jax_dcnet
from captionkit.models import editnet as jax_editnet
from captionkit.models import get_model as jax_get_model
from captionkit.ops import megastep as jax_megastep
from captionkit.utils.config import ModelConfig as JaxModelConfig

from captionkit_torch.config import ModelConfig
from captionkit_torch.decode.beam import beam_search
from captionkit_torch.kernels import megastep
from captionkit_torch.models import dcnet as t_dcnet
from captionkit_torch.models import editnet as t_editnet
from captionkit_torch.models import get_model
from captionkit_torch.params import (
    dcnet_params_from_numpy,
    editnet_params_from_numpy,
)

CFG = dict(vocab_size=30, emb_dim=12, hidden_dim=16, att_dim=8, feat_dim=10,
           num_regions=4, dropout=0.0)
ATOL = {"float32": 2e-5, "bfloat16": 1e-3}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _arrays(jp):
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    return {"/".join(str(getattr(k, "name", k)) for k in path):
            np.asarray(leaf) for path, leaf in flat}


def _setup(arch, dtype, batch=3, t_in=6, k=1, seed=0, **over):
    """(JAX cfg, params, beam-expanded ctx; port cfg, params, ctx) on the
    same weights and inputs."""
    kw = dict(CFG, arch=arch, compute_dtype=dtype, **over)
    jcfg, tcfg = JaxModelConfig(**kw), ModelConfig(**kw)
    jmod, tmod = ((jax_editnet, t_editnet) if arch == "editnet"
                  else (jax_dcnet, t_dcnet))
    jp = jmod.init(jax.random.PRNGKey(seed), jcfg)
    bridge = (editnet_params_from_numpy if arch == "editnet"
              else dcnet_params_from_numpy)
    tp = bridge(_arrays(jp), "cpu")
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal(
        (batch, CFG["num_regions"], CFG["feat_dim"])).astype(np.float32)
    ex = rng.integers(4, CFG["vocab_size"], (batch, t_in)).astype(np.int32)
    ln = rng.integers(2, t_in + 1, (batch,)).astype(np.int32)
    ln[0] = 2  # at least one padded (masked) caption position
    jctx = jmod.encode(jp, jcfg, jnp.asarray(feats), jnp.asarray(ex),
                       jnp.asarray(ln))
    tctx = tmod.encode(tp, tcfg, torch.from_numpy(feats),
                       torch.from_numpy(ex).long(), torch.from_numpy(ln).long())
    if k > 1:
        jctx, tctx = jmod.beam_expand(jctx, k), tmod.beam_expand(tctx, k)
    return jcfg, jp, jctx, tcfg, tp, tctx


def _close(j, t, atol, msg=""):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=atol, err_msg=msg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 3])
def test_fused_step_hidden_matches_jax_chained(dtype, k):
    """Four chained steps, each side fed its own state: the port's
    ``fused_step_hidden`` against JAX's (interpret) and JAX's jnp
    ``_step_hidden``."""
    jcfg, jp, jctx, tcfg, tp, tctx = _setup("editnet", dtype, k=k)
    jpack = jax_megastep.prepare_cell_pack(jp, jcfg, jctx)
    tpack = megastep.prepare_cell_pack(tp, tcfg, tctx)
    assert tpack.w_ha.shape == (128, 4 * 128)  # H = 16 padded to 128
    js_ref = js = jax_editnet.init_state(jp, jctx)
    ts = t_editnet.init_state(tp, tctx)
    rng = np.random.default_rng(1)
    atol = ATOL[dtype]
    names = ("h_att", "c_att", "h_lang", "c_lang")
    for step_i in range(4):
        tok = rng.integers(4, CFG["vocab_size"], (3 * k,)).astype(np.int32)
        js_ref, _ = jax_editnet._step_hidden(jp, jcfg, jctx, js_ref,
                                             jnp.asarray(tok))
        jout = jax_megastep.fused_step_hidden(
            jpack, js.h_att, js.c_att, js.h_lang, js.c_lang,
            jp.embedding[jnp.asarray(tok)], num_regions=CFG["num_regions"],
            compute_dtype=JDT[dtype], interpret=True)
        js = js.replace(**dict(zip(names, jout)))
        tout = megastep.fused_step_hidden(
            tpack, ts.h_att, ts.c_att, ts.h_lang, ts.c_lang,
            tp.embedding[torch.from_numpy(tok).long()])
        ts = t_editnet.EditNetState(*tout)
        for name in names:
            got = getattr(ts, name)
            assert tuple(got.shape) == (3 * k, CFG["hidden_dim"])
            msg = f"step {step_i} {name} k={k}"
            _close(getattr(js, name), got, atol, msg + " vs fused")
            _close(getattr(js_ref, name), got, atol, msg + " vs jnp")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_att_phase_alpha_beta_match_jax(dtype):
    """α and β of the port's ``att_cell`` against those inside JAX's
    ``att_phase``, read out through identity features and copy pool (each
    α/β column lands in its own output column). JAX's padded columns are
    exactly 0; a masked caption position gets weight exactly 0; the
    port's h_att, c_att, v̂ and c* match JAX's ``att_phase``."""
    k = 3
    jcfg, jp, jctx, tcfg, tp, tctx = _setup("editnet", dtype, k=k)
    jpack = jax_megastep.prepare_cell_pack(jp, jcfg, jctx)
    tpack = megastep.prepare_cell_pack(tp, tcfg, tctx)
    B, Rp, Fp = jpack.features.shape
    Tp, Hp = jpack.enc_cs.shape[1:]
    eye = lambda n, m: jnp.broadcast_to(  # noqa: E731
        jnp.eye(n, m, dtype=jpack.features.dtype), (B, n, m))
    jprobe = jpack._replace(features=eye(Rp, Fp), enc_cs=eye(Tp, Hp))
    rng = np.random.default_rng(2)
    N, H, E = 3 * k, CFG["hidden_dim"], CFG["emb_dim"]
    h_att, c_att, h_lang = (rng.standard_normal((N, H)).astype(np.float32)
                            * 0.5 for _ in range(3))
    emb = rng.standard_normal((N, E)).astype(np.float32) * 0.1
    kw = dict(num_regions=CFG["num_regions"], compute_dtype=JDT[dtype],
              interpret=True)
    args = [jnp.asarray(x) for x in (h_att, c_att, h_lang, emb)]
    _, _, j_alpha, j_beta = jax_megastep.att_phase(jprobe, *args, **kw)
    j_h, j_c, j_vhat, j_cstar = jax_megastep.att_phase(jpack, *args, **kw)

    t = [torch.from_numpy(x) for x in (h_att, c_att, h_lang, emb)]
    pad = lambda x, w: megastep._pad_to(x, 1, w)  # noqa: E731
    t_h, t_c, t_alpha, t_beta = megastep.att_cell(
        tpack, pad(t[3], tpack.w_emb.shape[0]), pad(t[0], Hp), pad(t[1], Hp),
        pad(t[2], Hp))
    R, T = CFG["num_regions"], tctx.mask.shape[1]
    assert tuple(t_alpha.shape) == (N, R) and tuple(t_beta.shape) == (N, T)
    assert t_alpha.dtype == t_beta.dtype == megastep._cdt(tcfg)
    j_alpha, j_beta = np.asarray(j_alpha), np.asarray(j_beta)
    assert not j_alpha[:, R:].any() and not j_beta[:, T:].any()
    atol = ATOL[dtype]
    _close(j_alpha[:, :R], t_alpha, atol, "alpha")
    _close(j_beta[:, :T], t_beta, atol, "beta")
    masked = ~tctx.mask.repeat_interleave(k, dim=0)
    assert bool(masked.any())
    assert bool((t_beta[masked] == 0).all())
    torch.testing.assert_close(t_beta.float().sum(1), torch.ones(N),
                               atol=2e-2, rtol=0)
    _close(j_h, t_h, atol, "h_att")
    _close(j_c, t_c, atol, "c_att")
    t_h2, t_c2, t_vhat, t_cstar = megastep.att_phase(
        tpack, t[0], t[1], t[2], t[3])
    _close(j_vhat, t_vhat, atol, "vhat_raw")
    _close(j_cstar, t_cstar, atol, "c_star")
    assert not t_h2[:, H:].any() and not t_cstar[:, H:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 3])
def test_dcnet_fused_step_hidden_matches_jax_chained(dtype, k):
    jcfg, jp, jctx, tcfg, tp, tctx = _setup("dcnet", dtype, k=k)
    jpack = jax_megastep.prepare_dcnet_cell_pack(jp, jcfg, jctx)
    tpack = megastep.prepare_dcnet_cell_pack(tp, tcfg, tctx)
    js_ref = js = jax_dcnet.init_state(jp, jctx)
    ts = t_dcnet.init_state(tp, tctx)
    rng = np.random.default_rng(1)
    atol = ATOL[dtype]
    for step_i in range(4):
        tok = rng.integers(4, CFG["vocab_size"], (3 * k,)).astype(np.int32)
        js_ref, _ = jax_dcnet._step_hidden(jp, jcfg, jctx, js_ref,
                                           jnp.asarray(tok))
        h, c = jax_megastep.dcnet_fused_step_hidden(
            jpack, js.h, js.c, jp.embedding[jnp.asarray(tok)],
            compute_dtype=JDT[dtype], interpret=True)
        js = js.replace(h=h, c=c)
        th, tc = megastep.dcnet_fused_step_hidden(
            tpack, ts.h, ts.c, tp.embedding[torch.from_numpy(tok).long()])
        ts = t_dcnet.DCNetState(h=th, c=tc)
        for name in ("h", "c"):
            msg = f"step {step_i} {name} k={k}"
            _close(getattr(js, name), getattr(ts, name), atol, msg)
            _close(getattr(js_ref, name), getattr(ts, name), atol,
                   msg + " vs jnp")


def test_dcnet_omega_masks_padding():
    """ω is exactly 0 at masked caption positions and sums to 1."""
    _, _, _, tcfg, tp, tctx = _setup("dcnet", "float32", k=3)
    pack = megastep.prepare_dcnet_cell_pack(tp, tcfg, tctx)
    h = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (9, pack.w_h.shape[0])).astype(np.float32))
    omega = megastep.dcnet_score(pack, h)
    masked = ~tctx.mask.repeat_interleave(3, dim=0)
    assert bool(masked.any()) and bool((omega[masked] == 0).all())
    torch.testing.assert_close(omega.sum(1), torch.ones(9), atol=1e-6,
                               rtol=0)


def _jax_whole(maker, out_shape, *args):
    """One of ``captionkit.ops.megastep``'s Pallas kernels on whole arrays
    (one grid step), in interpret mode."""
    from jax.experimental import pallas as pl

    return pl.pallas_call(maker, out_shape=out_shape, interpret=True)(*args)


def _padded(rng, n, width, padded, scale):
    """[n, width] standard normals times ``scale``, zero-padded to
    ``padded`` columns, fp32."""
    x = rng.standard_normal((n, width)).astype(np.float32) * scale
    return np.pad(x, ((0, 0), (0, padded - width)))


def _weights_close(j, t, dtype, msg):
    """Attention weights: fp32 within the fp32 bar; bf16 within one bf16
    ulp of the larger value (both sides sum the same fp32 terms in other
    orders, so a weight may round to the neighbouring bf16 value)."""
    j = np.asarray(j, np.float32)
    t = t.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(t, j, atol=ATOL[dtype], rtol=0,
                                   err_msg=msg)
        return
    _, e = np.frexp(np.maximum(np.abs(j), np.abs(t)))
    assert (np.abs(t - j) <= np.ldexp(1.0, e - 8)).all(), msg


# Row counts that leave ragged tiles (N = 1, 65) and widths that pad to one
# 128 block (E = 12, H = 16; E = H = 48).
RAGGED = [(1, 1, {}), (13, 5, {}), (13, 5, dict(emb_dim=48, hidden_dim=48))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,k,over", RAGGED)
def test_reference_att_cell_matches_jax_kernel(dtype, batch, k, over):
    """``reference_att_cell``, the plain version the card holds
    ``att_cell`` against, against the reference's att kernel
    (``_make_att_kernel``, interpret) on the same packs and inputs: h and
    c within the dtype's bar, α and β as ``_weights_close`` says."""
    jcfg, jp, jctx, tcfg, tp, tctx = _setup("editnet", dtype, batch=batch,
                                            k=k, **over)
    jpack = jax_megastep.prepare_cell_pack(jp, jcfg, jctx)
    tpack = megastep.prepare_cell_pack(tp, tcfg, tctx)
    N, E, H = batch * k, jcfg.emb_dim, jcfg.hidden_dim
    Ep, Hp = tpack.w_emb.shape[0], tpack.hp
    rng = np.random.default_rng(3)
    h_att, c_att, h_lang = (_padded(rng, N, H, Hp, 0.5) for _ in range(3))
    emb = _padded(rng, N, E, Ep, 0.1)
    dt = JDT[dtype]
    R, T = CFG["num_regions"], tctx.mask.shape[1]
    Rp, Tp = jpack.vis_keys.shape[1], jpack.scma_keys.shape[1]
    f32 = jnp.float32
    j = _jax_whole(
        jax_megastep._make_att_kernel(k, R, dt),
        [jax.ShapeDtypeStruct((N, Hp), f32), jax.ShapeDtypeStruct((N, Hp), f32),
         jax.ShapeDtypeStruct((N, Rp), dt), jax.ShapeDtypeStruct((N, Tp), dt)],
        jnp.asarray(emb).astype(dt), jnp.asarray(h_att), jnp.asarray(c_att),
        jnp.asarray(h_lang), jpack.zvb, jpack.w_emb, jpack.w_hl, jpack.w_ha,
        jpack.vis_wq, jpack.vis_v, jpack.vis_b, jpack.vis_keys,
        jpack.scma_wq, jpack.scma_v, jpack.scma_b, jpack.scma_keys,
        jpack.scma_mask)
    t = megastep.reference_att_cell(
        tpack, *(torch.from_numpy(x) for x in (emb, h_att, c_att, h_lang)))
    assert tuple(t[2].shape) == (N, R) and tuple(t[3].shape) == (N, T)
    _close(j[0], t[0], ATOL[dtype], "h_att")
    _close(j[1], t[1], ATOL[dtype], "c_att")
    _weights_close(np.asarray(j[2], np.float32)[:, :R], t[2], dtype, "alpha")
    _weights_close(np.asarray(j[3], np.float32)[:, :T], t[3], dtype, "beta")


def _dcnet_lstm_jax(jpack, dt, emb, ctx, h, c):
    N, Hp = h.shape
    out = jax.ShapeDtypeStruct((N, Hp), jnp.float32)
    return _jax_whole(
        jax_megastep._make_dcnet_lstm_kernel(dt), [out, out],
        jnp.asarray(emb).astype(dt), jnp.asarray(ctx), jnp.asarray(h),
        jnp.asarray(c), jpack.gate_w, jpack.gate_b, jpack.w_emb,
        jpack.w_part, jpack.w_h, jpack.b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,k,over", RAGGED)
def test_reference_dcnet_cell_matches_jax_kernel(dtype, batch, k, over):
    """``reference_dcnet_cell`` against the reference's DCNet LSTM kernel
    (``_make_dcnet_lstm_kernel``, interpret) on the same packs and
    inputs: h and c within the dtype's bar."""
    jcfg, jp, jctx, tcfg, tp, tctx = _setup("dcnet", dtype, batch=batch,
                                            k=k, **over)
    jpack = jax_megastep.prepare_dcnet_cell_pack(jp, jcfg, jctx)
    tpack = megastep.prepare_dcnet_cell_pack(tp, tcfg, tctx)
    N, E, H = batch * k, jcfg.emb_dim, jcfg.hidden_dim
    Ep, Hp = tpack.w_emb.shape[0], tpack.hp
    rng = np.random.default_rng(4)
    ctx, h, c = (_padded(rng, N, H, Hp, 0.5) for _ in range(3))
    emb = _padded(rng, N, E, Ep, 0.1)
    j = _dcnet_lstm_jax(jpack, JDT[dtype], emb, ctx, h, c)
    t = megastep.reference_dcnet_cell(
        tpack, *(torch.from_numpy(x) for x in (emb, ctx, h, c)))
    _close(j[0], t[0], ATOL[dtype], "h")
    _close(j[1], t[1], ATOL[dtype], "c")


@pytest.mark.parametrize("over", [{}, dict(emb_dim=48, hidden_dim=48)])
def test_reference_dcnet_cell_rounds_the_gated_context_once(over):
    """bf16, every ctx value halfway between bf16 neighbours: the
    reference multiplies the fp32 context unrounded and rounds the product
    once, and so does ``reference_dcnet_cell``. A pack built to read the
    gated context back (gate_w = 0 with a random gate_b, the decoder's
    part rows the identity into the i gate, every other weight 0, the g
    and o biases 20, c = 0) gives c' = sigmoid(part): one bf16 ulp of part
    moves c' by ~1e-3, so the two sides agree within 1e-6; ctx rounded to
    bf16 first moves c' by more than 1e-4."""
    jcfg, jp, jctx, tcfg, tp, tctx = _setup("dcnet", "bfloat16", batch=13,
                                            k=5, **over)
    jpack = jax_megastep.prepare_dcnet_cell_pack(jp, jcfg, jctx)
    tpack = megastep.prepare_dcnet_cell_pack(tp, tcfg, tctx)
    N, E, H = 65, jcfg.emb_dim, jcfg.hidden_dim
    Ep, Hp = tpack.w_emb.shape[0], tpack.hp
    rng = np.random.default_rng(7)
    gate_b = rng.standard_normal(Hp).astype(np.float32)
    w_part = np.zeros((Hp, 4 * Hp), np.float32)
    w_part[:, :Hp] = np.eye(Hp)
    b = np.zeros(4 * Hp, np.float32)
    b[2 * Hp:] = 20.0
    x = rng.standard_normal((N, Hp)).astype(np.float32)
    ctx = ((x.view(np.uint32) & 0xFFFF0000) | 0x8000).view(np.float32)
    emb, h = _padded(rng, N, E, Ep, 0.1), _padded(rng, N, H, Hp, 0.5)
    c = np.zeros((N, Hp), np.float32)
    bf = jnp.bfloat16
    jpack = jpack._replace(
        gate_w=jnp.zeros_like(jpack.gate_w), gate_b=jnp.asarray(gate_b)[None],
        w_emb=jnp.zeros_like(jpack.w_emb), w_part=jnp.asarray(w_part, bf),
        w_h=jnp.zeros_like(jpack.w_h), b=jnp.asarray(b)[None])
    tpack = dataclasses.replace(
        tpack, gate_w=torch.zeros_like(tpack.gate_w),
        gate_b=torch.from_numpy(gate_b),
        dec_w=torch.cat([torch.zeros((Ep, 4 * Hp)), torch.from_numpy(w_part),
                         torch.zeros((Hp, 4 * Hp))]).bfloat16(),
        b=torch.from_numpy(b))
    j = _dcnet_lstm_jax(jpack, bf, emb, ctx, h, c)
    t_in = [torch.from_numpy(v) for v in (emb, ctx, h, c)]
    part = torch.empty((N, Hp), dtype=torch.bfloat16)
    t = megastep.reference_dcnet_cell(tpack, *t_in, part=part)
    want = (torch.sigmoid(torch.from_numpy(gate_b)) * t_in[1]).bfloat16()
    assert torch.equal(part, want)
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), atol=1e-6,
                               rtol=0)
    t_in[1] = t_in[1].bfloat16().float()
    bad = megastep.reference_dcnet_cell(tpack, *t_in)
    assert float((bad[1] - t[1]).abs().max()) > 1e-4


def _decode_inputs(B=4, t_in=6, seed=2):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal(
        (B, CFG["num_regions"], CFG["feat_dim"])).astype(np.float32)
    ex = rng.integers(4, CFG["vocab_size"], (B, t_in)).astype(np.int32)
    ln = rng.integers(2, t_in + 1, (B,)).astype(np.int32)
    return feats, ex, ln


@pytest.mark.parametrize("arch", ["editnet", "dcnet"])
@pytest.mark.parametrize("K", [1, 3, 5])
def test_beam_decode_pallas_cells_identical_to_jax(arch, K):
    """Beam search with ``cell_impl="pallas"``: the same tokens as JAX's
    (interpret), scores within 2e-4 (the bar of tests/test_megastep.py)."""
    kw = dict(CFG, arch=arch, compute_dtype="float32", cell_impl="pallas")
    jm, tm = jax_get_model(JaxModelConfig(**kw)), get_model(ModelConfig(**kw))
    jp = jm.init(jax.random.PRNGKey(2))
    tp = (editnet_params_from_numpy if arch == "editnet"
          else dcnet_params_from_numpy)(_arrays(jp), "cpu")
    feats, ex, ln = _decode_inputs()
    jctx = jm.encode(jp, jnp.asarray(feats), jnp.asarray(ex), jnp.asarray(ln))
    tctx = tm.encode(tp, torch.from_numpy(feats), torch.from_numpy(ex).long(),
                     torch.from_numpy(ln).long())
    bk = dict(beam_size=K, start_id=2, end_id=3, max_len=8)
    j = jax_beam_search(jm, jp, jctx, impl="register", **bk)
    packed = []
    step_topk = tm.step_topk

    def spy(params, ctx, state, token, k):
        packed.append(ctx.cell_pack is not None)
        return step_topk(params, ctx, state, token, k)

    t = beam_search(dataclasses.replace(tm, step_topk=spy), tp, tctx, **bk)
    assert packed and all(packed)  # every step took the fused cells
    np.testing.assert_array_equal(t.tokens.numpy(), np.asarray(j.tokens))
    np.testing.assert_allclose(t.scores.numpy(), np.asarray(j.scores),
                               rtol=2e-4, atol=2e-4)


def test_wholestep_still_raises():
    """``cell_impl="wholestep"`` builds for both archs: EditNet's
    ``prepare_topk`` gives it the fused-cell pack (the whole-step kernel's
    first half is ``att_phase``), DCNet's none (plain cells, as in the
    reference)."""
    for arch in ("editnet", "dcnet"):
        _, _, _, _, tp, tctx = _setup(arch, "float32", k=3)
        model = get_model(ModelConfig(**dict(CFG, arch=arch,
                                             compute_dtype="float32",
                                             cell_impl="wholestep")))
        ctx_k = model.prepare_topk(tp, tctx, 3)
        assert (ctx_k.cell_pack is not None) == (arch == "editnet")


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    """On a CPU tensor each wrapper is its plain version and counts no
    launch."""
    _, _, _, tcfg, tp, tctx = _setup("dcnet", "float32", k=3)
    pack = megastep.prepare_dcnet_cell_pack(tp, tcfg, tctx)
    before = megastep.dcnet_score.launches
    megastep.dcnet_score(pack, torch.zeros((9, pack.w_h.shape[0])))
    assert megastep.dcnet_score.launches == before
