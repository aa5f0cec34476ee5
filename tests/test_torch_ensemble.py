"""The port's checkpoint ensembles (``captionkit_torch.models.ensemble``)
against ``captionkit.models.ensemble`` on the CPU: the same member
weights (JAX inits, bridged by name), the same inputs from a numpy seed,
fp32.

Tolerances: tokens identical; scores and combined log-probs within 1e-5
(fp32 sums in other orders; the combined head sums M·H products where
each member's head sums H). The int8 combined head is held against JAX's
``xla_head_topk_int8`` ensemble: the same quantized arithmetic, tokens
identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionkit.decode import beam_search as j_beam
from captionkit.decode import greedy_decode as j_greedy
from captionkit.models import ensemble_model as j_ensemble
from captionkit.models import get_model as jax_get_model
from captionkit.models import stack_params as j_stack
from captionkit.train.checkpoint import save_params_npz as jax_save_npz
from captionkit.utils.config import ModelConfig as JaxModelConfig

from captionkit_torch.config import ModelConfig
from captionkit_torch.decode import beam_search, greedy_decode
from captionkit_torch.models import get_model
from captionkit_torch.models.ensemble import (
    _combine,
    ensemble_model,
    load_ensemble_params,
    stack_params,
)
from captionkit_torch.params import (
    dcnet_params_from_numpy,
    editnet_params_from_numpy,
    named_tensors,
)

CFG = dict(vocab_size=30, emb_dim=12, hidden_dim=16, att_dim=8,
           feat_dim=10, num_regions=4, dropout=0.0, compute_dtype="float32")
START, END, PAD = 2, 3, 0
B, T, L, K = 4, 6, 8, 3


def _flat(jp):
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    return {"/".join(str(getattr(k, "name", k)) for k in path):
            np.asarray(leaf) for path, leaf in flat if leaf is not None}


def _bridge(arch, jp):
    fn = (editnet_params_from_numpy if arch == "editnet"
          else dcnet_params_from_numpy)
    return fn(_flat(jp), "cpu")


def _setup(arch="editnet", M=2, mode="logprob", jax_over=None, **over):
    """(JAX ensemble, its params, port ensemble, its params, member
    ModelDefs, inputs as numpy)."""
    jcfg = JaxModelConfig(arch=arch, **{**CFG, **over, **(jax_over or {})})
    tcfg = ModelConfig(arch=arch, **{**CFG, **over})
    jm, tm = jax_get_model(jcfg), get_model(tcfg)
    jps = [jm.init(jax.random.PRNGKey(i)) for i in range(M)]
    rng = np.random.default_rng(M)
    inputs = (rng.standard_normal((B, 4, 10)).astype(np.float32),
              rng.integers(4, 30, (B, T)).astype(np.int32),
              rng.integers(2, T + 1, (B,)).astype(np.int32))
    return (j_ensemble(jm, M, mode=mode), j_stack(jps),
            ensemble_model(tm, M, mode=mode),
            stack_params([_bridge(arch, p) for p in jps]), (jm, tm), inputs)


def _encode_both(je, jp, te, tp, inputs):
    f, e, n = inputs
    jctx = je.encode(jp, jnp.asarray(f), jnp.asarray(e), jnp.asarray(n))
    tctx = te.encode(tp, torch.from_numpy(f), torch.from_numpy(e).long(),
                     torch.from_numpy(n).long())
    return jctx, tctx


def _beams(model, params, ctx, impl="register", jax_side=False):
    kw = dict(beam_size=K, start_id=START, end_id=END, pad_id=PAD,
              max_len=L, impl=impl)
    if jax_side:
        r = j_beam(model, params, ctx, **kw)
        return np.asarray(r.tokens), np.asarray(r.scores)
    with torch.no_grad():
        r = beam_search(model, params, ctx, **kw)
    return r.tokens.numpy(), r.scores.numpy()


def test_stack_params_errors():
    ed = get_model(ModelConfig(arch="editnet", **CFG))
    dc = get_model(ModelConfig(arch="dcnet", **CFG))
    wide = get_model(ModelConfig(arch="editnet", **{**CFG,
                                                    "hidden_dim": 24}))
    a = ed.init(0, "cpu")
    with pytest.raises(ValueError, match="at least one member"):
        stack_params([])
    with pytest.raises(ValueError, match="different parameter structures"):
        stack_params([a, dc.init(0, "cpu")])
    with pytest.raises(ValueError, match="leaf shape"):
        stack_params([a, wide.init(0, "cpu")])
    with pytest.raises(ValueError, match="ensemble mode"):
        ensemble_model(ed, 2, mode="votes")
    with pytest.raises(ValueError, match="num_members"):
        ensemble_model(ed, 0)
    ens = ensemble_model(ed, 3)
    with pytest.raises(ValueError, match="3-member ensemble got 2"):
        ens.encode(stack_params([a, a]), torch.zeros(1, 4, 10),
                   torch.ones(1, 2, dtype=torch.long),
                   torch.ones(1, dtype=torch.long))


@pytest.mark.parametrize("mode", ["logprob", "prob"])
def test_combine_matches_numpy(mode):
    x = np.random.default_rng(0).standard_normal((5, 3, 11)).astype(
        np.float32)
    got = _combine(torch.from_numpy(x), mode).numpy()
    if mode == "logprob":
        want = x.mean(axis=1)
    else:
        lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
        want = np.log(np.exp(lp).mean(axis=1))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", ["logprob", "prob"])
@pytest.mark.parametrize("arch", ["editnet", "dcnet"])
def test_duplicate_members_equal_single_model(arch, mode):
    """Two copies of one checkpoint decode what the checkpoint alone
    decodes: beam and greedy tokens identical, scores within 1e-5."""
    _, _, _, _, (jm, tm), inputs = _setup(arch)
    p = _bridge(arch, jm.init(jax.random.PRNGKey(5)))
    ens, dup = ensemble_model(tm, 2, mode=mode), stack_params([p, p])
    f, e, n = (torch.from_numpy(inputs[0]), torch.from_numpy(inputs[1])
               .long(), torch.from_numpy(inputs[2]).long())
    ctx, ectx = tm.encode(p, f, e, n), ens.encode(dup, f, e, n)
    t1, s1 = _beams(tm, p, ctx)
    t2, s2 = _beams(ens, dup, ectx)
    np.testing.assert_array_equal(t2, t1)
    np.testing.assert_allclose(s2, s1, atol=1e-5, rtol=0)
    with torch.no_grad():
        kw = dict(start_id=START, end_id=END, pad_id=PAD, max_len=L)
        g1 = greedy_decode(tm, p, ctx, **kw)
        g2 = greedy_decode(ens, dup, ectx, **kw)
    assert torch.equal(g1.tokens, g2.tokens)
    np.testing.assert_allclose(g2.logprobs.numpy(), g1.logprobs.numpy(),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch,M,impl", [
    ("editnet", 2, "register"), ("editnet", 2, "backptr"),
    ("editnet", 3, "register"), ("editnet", 3, "backptr"),
    ("dcnet", 2, "register"), ("dcnet", 3, "backptr")])
def test_ensemble_beam_matches_jax(arch, M, impl):
    """The logprob ensemble's beam (the combined head: kernel route, its
    plain version here) against JAX's on the same members, both history
    layouts; prob mode's full-logits beam and greedy too."""
    je, jp, te, tp, _, inputs = _setup(arch, M)
    jctx, tctx = _encode_both(je, jp, te, tp, inputs)
    jt, js = _beams(je, jp, jctx, impl, jax_side=True)
    tt, ts = _beams(te, tp, tctx, impl)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(ts, js, atol=1e-5, rtol=0)
    if impl == "register":
        je, jp, te, tp, _, inputs = _setup(arch, M, mode="prob")
        assert te.step_topk is None and te.prepare_topk is None
        jctx, tctx = _encode_both(je, jp, te, tp, inputs)
        jt, js = _beams(je, jp, jctx, jax_side=True)
        tt, ts = _beams(te, tp, tctx)
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_allclose(ts, js, atol=1e-5, rtol=0)
        kw = dict(start_id=START, end_id=END, pad_id=PAD, max_len=L)
        with torch.no_grad():
            g = greedy_decode(te, tp, tctx, **kw)
        jg = j_greedy(je, jp, jctx, **kw)
        np.testing.assert_array_equal(g.tokens.numpy(),
                                      np.asarray(jg.tokens))
        np.testing.assert_allclose(g.logprobs.numpy(),
                                   np.asarray(jg.logprobs), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_fused_combined_head_equals_fallback(impl):
    """The combined head after each member's ``step_hidden`` (one product
    at H' = M·H) against the ensemble of members without a fused head
    (M full logits, their mean, then the beam's full-logits branch)."""
    _, _, te, tp, _, inputs = _setup(head_impl=impl)
    plain = ensemble_model(get_model(ModelConfig(
        arch="editnet", use_fused_head=False, **CFG)), 2)
    assert te.step_topk is not None and plain.step_topk is None
    f, e, n = (torch.from_numpy(inputs[0]), torch.from_numpy(inputs[1])
               .long(), torch.from_numpy(inputs[2]).long())
    t1, s1 = _beams(te, tp, te.encode(tp, f, e, n))
    t2, s2 = _beams(plain, tp, plain.encode(tp, f, e, n))
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_allclose(s1, s2, atol=1e-5, rtol=0)
    # One combined head in the prepared context, not M member heads.
    with torch.no_grad():
        ctx = te.prepare_topk(tp, te.beam_expand(te.encode(tp, f, e, n),
                                                 K), K)
    if impl == "pallas":
        assert ctx.head_w.shape[0] == 2 * CFG["hidden_dim"]
    assert all(c.head_w is None for c in ctx.members)


def test_int8_combined_head_matches_jax():
    """head_quant="int8": the combined head quantized once a batch
    (``quantize_head`` of W_m/M) through the int8 kernel's route (its
    plain version here) against JAX's ``xla_head_topk_int8`` ensemble."""
    je, jp, te, tp, _, inputs = _setup(head_quant="int8",
                                       jax_over={"head_impl": "xla"})
    jctx, tctx = _encode_both(je, jp, te, tp, inputs)
    jt, js = _beams(je, jp, jctx, jax_side=True)
    tt, ts = _beams(te, tp, tctx)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(ts, js, atol=1e-5, rtol=0)
    with torch.no_grad():
        ctx = te.prepare_topk(tp, te.beam_expand(tctx, K), K)
    assert ctx.head_w.dtype == torch.int8 and ctx.head_wt is not None


def test_load_ensemble_params_reads_jax_npz(tmp_path):
    jm = jax_get_model(JaxModelConfig(arch="dcnet", **CFG))
    tm = get_model(ModelConfig(arch="dcnet", **CFG))
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"m{i}.npz"))
        jax_save_npz(jm.init(jax.random.PRNGKey(i)), paths[-1])
    got = load_ensemble_params(tm, paths, "cpu")
    assert len(got.members) == 2
    for i, member in enumerate(got.members):
        want = _flat(jm.init(jax.random.PRNGKey(i)))
        for n, t in named_tensors(member).items():
            np.testing.assert_array_equal(t.numpy(), want[n])
    with pytest.raises(ValueError, match="holds dcnet weights"):
        load_ensemble_params(get_model(ModelConfig(arch="editnet", **CFG)),
                             paths, "cpu")


@pytest.mark.parametrize("arch", ["editnet", "dcnet"])
def test_members_run_their_cell_packs(arch):
    """With ``cell_impl="pallas"`` the ensemble prepares each member's
    fused-cell pack (``ModelDef.prepare_cells``) beside the one combined
    head, and the beam equals the plain-cell ensemble's (fp32: the packs'
    plain versions and the plain cells compute the same steps)."""
    _, _, te, tp, _, inputs = _setup(arch)
    packed = ensemble_model(get_model(ModelConfig(
        arch=arch, cell_impl="pallas", **CFG)), 2)
    f, e, n = (torch.from_numpy(inputs[0]), torch.from_numpy(inputs[1])
               .long(), torch.from_numpy(inputs[2]).long())
    with torch.no_grad():
        ctx = packed.prepare_topk(tp, packed.beam_expand(
            packed.encode(tp, f, e, n), K), K)
    assert all(c.cell_pack is not None and c.head_w is None
               for c in ctx.members)
    assert ctx.head_w.shape[0] == 2 * CFG["hidden_dim"]
    t1, s1 = _beams(packed, tp, packed.encode(tp, f, e, n))
    t2, s2 = _beams(te, tp, te.encode(tp, f, e, n))
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_allclose(s1, s2, atol=1e-5, rtol=0)
