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
