"""The port's whole-step path (``captionkit_torch.kernels.wholestep``,
``cell_impl="wholestep"``) against ``captionkit.ops.wholestep`` on the
CPU, where the JAX package runs its Pallas kernels in interpret mode (as
``tests/test_wholestep.py`` does) and the port's wrappers run their plain
versions. Weights are the JAX ``init``, carried over by the flat-name
bridge; inputs come from numpy. Dims are small and unaligned (E=12, H=16,
A=8, F=10, R=4, V=30), so every padding path runs.

Tolerances: fp32 2e-5 (the reference's bar for its fused step against its
jnp step: the same products summed in another order); bf16 1e-3 (both
sides round the same operands at the same places; a value within an ulp
of a bf16 rounding boundary may round the other way). Top-k ids equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionkit.decode.beam import beam_search as jax_beam_search
from captionkit.models import editnet as jax_editnet
from captionkit.models import get_model as jax_get_model
from captionkit.ops import megastep as jax_megastep
from captionkit.ops.wholestep import fused_step_topk as jax_step_topk
from captionkit.utils.config import ModelConfig as JaxModelConfig

from captionkit_torch.config import ModelConfig
from captionkit_torch.decode.beam import beam_search
from captionkit_torch.kernels import megastep, wholestep
from captionkit_torch.kernels.head import prepad_head
from captionkit_torch.models import editnet as t_editnet
from captionkit_torch.models import get_model
from captionkit_torch.params import editnet_params_from_numpy

CFG = dict(vocab_size=30, emb_dim=12, hidden_dim=16, att_dim=8, feat_dim=10,
           num_regions=4, dropout=0.0)
ATOL = {"float32": 2e-5, "bfloat16": 1e-3}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _arrays(jp):
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    return {"/".join(str(getattr(k, "name", k)) for k in path):
            np.asarray(leaf) for path, leaf in flat}


def _setup(dtype, batch=3, t_in=6, k=1, seed=0, **over):
    kw = dict(CFG, arch="editnet", compute_dtype=dtype, **over)
    jcfg, tcfg = JaxModelConfig(**kw), ModelConfig(**kw)
    jp = jax_editnet.init(jax.random.PRNGKey(seed), jcfg)
    tp = editnet_params_from_numpy(_arrays(jp), "cpu")
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal(
        (batch, CFG["num_regions"], CFG["feat_dim"])).astype(np.float32)
    ex = rng.integers(4, CFG["vocab_size"], (batch, t_in)).astype(np.int32)
    ln = rng.integers(2, t_in + 1, (batch,)).astype(np.int32)
    ln[0] = 2  # at least one masked caption position
    jctx = jax_editnet.encode(jp, jcfg, jnp.asarray(feats), jnp.asarray(ex),
                              jnp.asarray(ln))
    tctx = t_editnet.encode(tp, tcfg, torch.from_numpy(feats),
                            torch.from_numpy(ex).long(),
                            torch.from_numpy(ln).long())
    if k > 1:
        jctx = jax_editnet.beam_expand(jctx, k)
        tctx = t_editnet.beam_expand(tctx, k)
    return jcfg, jp, jctx, tcfg, tp, tctx


def _close(j, t, atol, msg=""):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=atol, err_msg=msg)


_jax_step_topk = jax.jit(jax_step_topk, static_argnames=(
    "k", "num_regions", "compute_dtype", "interpret"))


@pytest.mark.parametrize("topk,dtype", [(1, "float32"), (3, "float32"),
                                        (5, "float32"), (5, "bfloat16")])
def test_fused_step_topk_matches_jax_chained(topk, dtype):
    """Four chained steps of the whole step, each side fed its own state:
    states, top-k values and lse within the bar, top-k ids equal."""
    k = 3
    jcfg, jp, jctx, tcfg, tp, tctx = _setup(dtype, k=k)
    jpack = jax_megastep.prepare_cell_pack(jp, jcfg, jctx)
    tpack = megastep.prepare_cell_pack(tp, tcfg, tctx)
    w_p, b_p = prepad_head(tp.fc_w, tp.fc_b, compute_dtype=TDT[dtype])
    js = jax_editnet.init_state(jp, jctx)
    ts = t_editnet.init_state(tp, tctx)
    rng = np.random.default_rng(1)
    atol = ATOL[dtype]
    names = ("h_att", "c_att", "h_lang", "c_lang")
    for step_i in range(4):
        tok = rng.integers(4, CFG["vocab_size"], (3 * k,)).astype(np.int32)
        jout = _jax_step_topk(
            jpack, js.h_att, js.c_att, js.h_lang, js.c_lang,
            jp.embedding[jnp.asarray(tok)], jp.fc_w, jp.fc_b, k=topk,
            num_regions=CFG["num_regions"], compute_dtype=JDT[dtype],
            interpret=True)
        js = js.replace(**dict(zip(names, jout[:4])))
        tout = wholestep.fused_step_topk(
            tpack, ts.h_att, ts.c_att, ts.h_lang, ts.c_lang,
            tp.embedding[torch.from_numpy(tok).long()], w_p, b_p, k=topk)
        ts = t_editnet.EditNetState(*tout[:4])
        msg = f"step {step_i} k={topk}"
        for name in names:
            assert tuple(getattr(ts, name).shape) == (3 * k,
                                                      CFG["hidden_dim"])
            _close(getattr(js, name), getattr(ts, name), atol,
                   f"{msg} {name}")
        np.testing.assert_array_equal(tout[5].numpy(), np.asarray(jout[5]),
                                      err_msg=f"{msg} ids")
        assert tout[5].dtype == torch.int32
        _close(jout[4], tout[4], atol, f"{msg} vals")
        _close(np.asarray(jout[6]), tout[6], atol, f"{msg} lse")


def test_lang_head_equals_lang_cell_then_head():
    """The plain whole step is the lang cell followed by the head of
    h_lang' rounded to the compute dtype, bit for bit (the same
    operations)."""
    from captionkit_torch.kernels.head import reference_head_topk

    _, _, _, tcfg, tp, tctx = _setup("bfloat16", k=2)
    pack = megastep.prepare_cell_pack(tp, tcfg, tctx)
    w_p, b_p = prepad_head(tp.fc_w, tp.fc_b, compute_dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(2)
    N, Hp = 6, pack.hp
    emb = torch.randn((N, CFG["emb_dim"]), generator=g)
    h_att, c_att, h_lang, c_lang = (torch.randn((N, CFG["hidden_dim"]),
                                                generator=g)
                                    for _ in range(4))
    h2, _, vhat_raw, c_star = megastep.att_phase(pack, h_att, c_att, h_lang,
                                                 emb)
    got = wholestep.fused_lang_head_topk(pack, vhat_raw, h2, c_star, h_lang,
                                         c_lang, w_p, b_p, k=4)
    pad = lambda x: megastep._pad_to(x, 1, Hp)  # noqa: E731
    hl, cl = megastep.lang_cell(pack, vhat_raw, h2, pad(h_lang),
                                pad(c_lang), c_star)
    H = CFG["hidden_dim"]
    assert torch.equal(got[0], hl[:, :H]) and torch.equal(got[1], cl[:, :H])
    want = reference_head_topk(hl.to(torch.bfloat16),
                               megastep._pad_to(w_p, 0, Hp), b_p, 4)
    for a, b in zip(got[2:], want):
        assert torch.equal(a, b)


def _decode_inputs(B=4, t_in=6, seed=7):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal(
        (B, CFG["num_regions"], CFG["feat_dim"])).astype(np.float32)
    ex = rng.integers(4, CFG["vocab_size"], (B, t_in)).astype(np.int32)
    ln = rng.integers(2, t_in + 1, (B,)).astype(np.int32)
    return feats, ex, ln


@pytest.mark.parametrize("K,max_len", [(3, 7), (5, 5)])
def test_beam_decode_wholestep_identical_to_jax_and_pallas(K, max_len,
                                                           monkeypatch):
    """Beam search with ``cell_impl="wholestep"``: every step takes the
    whole-step branch; the tokens equal JAX's whole-step decode
    (interpret) and the port's ``pallas`` decode, scores within 2e-4 (the
    bar of tests/test_wholestep.py)."""
    out = {}
    feats, ex, ln = _decode_inputs()
    bk = dict(beam_size=K, start_id=2, end_id=3, max_len=max_len)
    real = t_editnet.fused_step_topk
    for impl in ("pallas", "wholestep"):
        kw = dict(CFG, arch="editnet", compute_dtype="float32",
                  cell_impl=impl)
        jm, tm = jax_get_model(JaxModelConfig(**kw)), \
            get_model(ModelConfig(**kw))
        jp = jm.init(jax.random.PRNGKey(3))
        tp = editnet_params_from_numpy(_arrays(jp), "cpu")
        jctx = jm.encode(jp, jnp.asarray(feats), jnp.asarray(ex),
                         jnp.asarray(ln))
        tctx = tm.encode(tp, torch.from_numpy(feats),
                         torch.from_numpy(ex).long(),
                         torch.from_numpy(ln).long())
        calls = []

        def spy(*a, **k):
            calls.append(1)
            return real(*a, **k)

        monkeypatch.setattr(t_editnet, "fused_step_topk", spy)
        out[impl] = (jax_beam_search(jm, jp, jctx, impl="register", **bk),
                     beam_search(tm, tp, tctx, **bk))
        # The loop may stop before max_len once every beam has finished.
        assert (0 < len(calls) <= bk["max_len"]) == (impl == "wholestep")
    j, t = out["wholestep"]
    np.testing.assert_array_equal(t.tokens.numpy(), np.asarray(j.tokens))
    np.testing.assert_allclose(t.scores.numpy(), np.asarray(j.scores),
                               rtol=2e-4, atol=2e-4)
    assert torch.equal(t.tokens, out["pallas"][1].tokens)
    np.testing.assert_allclose(t.scores.numpy(),
                               out["pallas"][1].scores.numpy(),
                               rtol=2e-4, atol=2e-4)


def test_wholestep_int8_head_falls_through_to_the_pallas_cells():
    """``cell_impl="wholestep"`` with ``head_quant="int8"`` takes the
    two-program path: the ``pallas`` cells, then the int8 head, exactly as
    ``cell_impl="pallas"`` with the int8 head; ids equal to JAX's."""
    k = 3
    jcfg, jp, jctx, tcfg, tp, tctx = _setup("float32", k=k,
                                            cell_impl="wholestep",
                                            head_quant="int8")
    tcfg_p = dataclasses.replace(tcfg, cell_impl="pallas")
    ctx_w = t_editnet.prepare_topk(tp, tcfg, tctx, k)
    ctx_p = t_editnet.prepare_topk(tp, tcfg_p, tctx, k)
    assert ctx_w.cell_pack is not None and ctx_w.head_scale is not None
    state = t_editnet.init_state(tp, ctx_w)
    tok = np.array([4, 5, 6, 7, 8, 9, 10, 11, 12], np.int32)
    got = t_editnet.step_topk(tp, tcfg, ctx_w, state,
                              torch.from_numpy(tok).long(), k)
    want = t_editnet.step_topk(tp, tcfg_p, ctx_p, state,
                               torch.from_numpy(tok).long(), k)
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
    jctx2 = jax_editnet.prepare_topk(jp, jcfg, jctx, k)
    jout = jax_editnet.step_topk(jp, jcfg, jctx2,
                                 jax_editnet.init_state(jp, jctx2),
                                 jnp.asarray(tok), k)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(jout[2]))
    _close(jout[3], got[3], 2e-4, "lse")


def test_cpu_tensors_count_no_launch():
    _, _, _, tcfg, tp, tctx = _setup("float32", k=2)
    pack = megastep.prepare_cell_pack(tp, tcfg, tctx)
    w_p, b_p = prepad_head(tp.fc_w, tp.fc_b, compute_dtype=torch.float32)
    before = wholestep.fused_lang_head_topk.launches
    z = torch.zeros((6, CFG["hidden_dim"]))
    wholestep.fused_step_topk(pack, z, z, z, z,
                              torch.zeros((6, CFG["emb_dim"])), w_p, b_p,
                              k=2)
    assert wholestep.fused_lang_head_topk.launches == before
