"""Beam widths above 8, fp32 compute and wide heads: the port's plain
versions (what every wrapper runs on the CPU) against the JAX reference on
the same inputs, the JAX side running its Pallas kernels in interpret
mode. The CUDA kernels' instances for these (k up to 64, fp32 products,
streamed h) are held against the same plain versions on a card in
test_torch_card.py.

Bars: fp32 head values and log-sum-exp within 1e-6 (the same fp32
products summed in another order), ids identical; int8 values within
2e-5 and lse within 2e-4 (tests/test_head_quant.py's bar), ids identical;
decodes: identical tokens, scores within 2e-4 (tests/test_megastep.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionkit.decode.beam import beam_search as jax_beam_search
from captionkit.models import editnet as jax_editnet
from captionkit.models import get_model as jax_get_model
from captionkit.ops import head as jhead
from captionkit.ops import megastep as jax_megastep
from captionkit.ops.wholestep import fused_step_topk as jax_step_topk
from captionkit.utils.config import ModelConfig as JaxModelConfig

from captionkit_torch.config import ModelConfig
from captionkit_torch.decode.beam import beam_search
from captionkit_torch.kernels import head as thead
from captionkit_torch.kernels import megastep, wholestep
from captionkit_torch.models import editnet as t_editnet
from captionkit_torch.models import get_model
from captionkit_torch.params import (
    dcnet_params_from_numpy,
    editnet_params_from_numpy,
)

KS = (9, 12, 16)


def _head_inputs(n, h, v, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, h)).astype(np.float32),
            (rng.standard_normal((h, v)) * h ** -0.5).astype(np.float32),
            rng.standard_normal((v,)).astype(np.float32))


def _same(j, t, atol=1e-6, lse_atol=None):
    jv, ji, jl = (np.asarray(x) for x in j)
    tv, ti, tl = (x.numpy() for x in t)
    assert ti.dtype == np.int32
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, atol=atol, rtol=0)
    np.testing.assert_allclose(tl, jl, atol=lse_atol or atol, rtol=0)


@pytest.mark.parametrize("k", [1, 8, 9, 16, 17, 32, 33, 64])
def test_kmax_for_picks_the_smallest_instance(k):
    m = thead.kmax_for(k)
    assert m in (8, 16, 32, 64) and m >= k and (m == 8 or m // 2 < k)


@pytest.mark.parametrize("k", [0, 65, 128])
def test_kmax_for_raises_past_the_largest_instance(k):
    with pytest.raises(ValueError, match="64"):
        thead.kmax_for(k)


@pytest.mark.parametrize("extract", ["mask", "thresh"])
@pytest.mark.parametrize("k", KS)
def test_head_above_k8_matches_pallas_interpret(k, extract):
    h, w, b = _head_inputs(24, 32, 300, k)
    got = thead.fused_head_topk(torch.from_numpy(h), torch.from_numpy(w),
                                torch.from_numpy(b), k=k, extract=extract)
    _same(jhead.fused_head_topk(jnp.asarray(h), jnp.asarray(w),
                                jnp.asarray(b), k=k, extract=extract,
                                interpret=True), got)


@pytest.mark.parametrize("k", KS)
def test_head_above_k8_ties_lowest_ids(k):
    """Integer logits with duplicates inside and across 128-wide tiles:
    the same ids as the reference, lowest first among equals."""
    rng = np.random.default_rng(k)
    pat = rng.integers(-2, 2, (8, 384)).astype(np.float32)
    pat[0] = 1.0
    h, b = np.eye(8, dtype=np.float32), np.zeros((384,), np.float32)
    got = thead.fused_head_topk(torch.from_numpy(h), torch.from_numpy(pat),
                                torch.from_numpy(b), k=k)
    assert got[1][0].tolist() == list(range(k))
    _same(jhead.fused_head_topk(jnp.asarray(h), jnp.asarray(pat),
                                jnp.asarray(b), k=k, interpret=True), got)


@pytest.mark.parametrize("k", KS)
def test_sweep_above_k8_matches_pallas_interpret(k):
    h, w, b = _head_inputs(16, 32, 700, k + 1)
    got = thead.head_sweep_topk(torch.from_numpy(h), torch.from_numpy(w),
                                torch.from_numpy(b), k=k)
    _same(jhead._sweep_head_topk(jnp.asarray(h), jnp.asarray(w),
                                 jnp.asarray(b), k=k,
                                 compute_dtype=jnp.float32, interpret=True),
          got)


def _int8_pair(h, w, b, k):
    jw = jhead.quantize_head(jnp.asarray(w), jnp.asarray(b),
                             n_rows=h.shape[0], k=k)
    tw = thead.quantize_head(torch.from_numpy(w), torch.from_numpy(b))
    got = thead.fused_head_topk_int8(torch.from_numpy(h), *tw, k=k)
    want = jhead.fused_head_topk_int8(jnp.asarray(h), *jw, k=k,
                                      interpret=True)
    return want, got


@pytest.mark.parametrize("k", KS)
def test_int8_head_above_k8_matches_jax(k):
    h, w, b = _head_inputs(16, 32, 257, k + 2)
    want, got = _int8_pair(h, w, b, k)
    _same(want, got, atol=2e-5, lse_atol=2e-4)


@pytest.mark.parametrize("k", [5, 16])
def test_wide_heads_match_jax(k):
    """H = 2048, past the sweep's resident h (1024) and two int8 chunks of
    1024: the plain sweep and the plain int8 head against JAX's."""
    h, w, b = _head_inputs(8, 2048, 300, k + 3)
    got = thead.head_sweep_topk(torch.from_numpy(h), torch.from_numpy(w),
                                torch.from_numpy(b), k=k)
    _same(jhead._sweep_head_topk(jnp.asarray(h), jnp.asarray(w),
                                 jnp.asarray(b), k=k,
                                 compute_dtype=jnp.float32, interpret=True),
          got, atol=1e-5)
    want, got = _int8_pair(h, w, b, k)
    _same(want, got, atol=2e-5, lse_atol=2e-4)


# -- the whole step and beam decodes ------------------------------------------

CFG = dict(vocab_size=30, emb_dim=12, hidden_dim=16, att_dim=8, feat_dim=10,
           num_regions=4, dropout=0.0)


def _arrays(jp):
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    return {"/".join(str(getattr(k, "name", k)) for k in path):
            np.asarray(leaf) for path, leaf in flat if leaf is not None}


_jax_step_topk = jax.jit(jax_step_topk, static_argnames=(
    "k", "num_regions", "compute_dtype", "interpret"))


@pytest.mark.parametrize("k", KS)
def test_wholestep_above_k8_matches_jax(k):
    """One whole step (fp32) at k > 8, JAX's kernel in interpret mode:
    states and top-k values within 2e-5, ids identical."""
    kw = dict(CFG, arch="editnet", compute_dtype="float32")
    jcfg, tcfg = JaxModelConfig(**kw), ModelConfig(**kw)
    jp = jax_editnet.init(jax.random.PRNGKey(k), jcfg)
    tp = editnet_params_from_numpy(_arrays(jp), "cpu")
    rng = np.random.default_rng(k)
    B, K = 2, 3
    feats = rng.standard_normal((B, 4, 10)).astype(np.float32)
    ex = rng.integers(4, 30, (B, 6)).astype(np.int32)
    ln = np.array([6, 3], np.int32)
    jctx = jax_editnet.beam_expand(jax_editnet.encode(
        jp, jcfg, jnp.asarray(feats), jnp.asarray(ex), jnp.asarray(ln)), K)
    tctx = t_editnet.beam_expand(t_editnet.encode(
        tp, tcfg, torch.from_numpy(feats), torch.from_numpy(ex).long(),
        torch.from_numpy(ln).long()), K)
    jpack = jax_megastep.prepare_cell_pack(jp, jcfg, jctx)
    tpack = megastep.prepare_cell_pack(tp, tcfg, tctx)
    w_p, b_p = thead.prepad_head(tp.fc_w, tp.fc_b,
                                 compute_dtype=torch.float32)
    js, ts = jax_editnet.init_state(jp, jctx), t_editnet.init_state(tp, tctx)
    tok = rng.integers(4, 30, (B * K,)).astype(np.int32)
    jout = _jax_step_topk(jpack, js.h_att, js.c_att, js.h_lang, js.c_lang,
                          jp.embedding[jnp.asarray(tok)], jp.fc_w, jp.fc_b,
                          k=k, num_regions=4, compute_dtype=jnp.float32,
                          interpret=True)
    tout = wholestep.fused_step_topk(
        tpack, ts.h_att, ts.c_att, ts.h_lang, ts.c_lang,
        tp.embedding[torch.from_numpy(tok).long()], w_p, b_p, k=k)
    np.testing.assert_array_equal(tout[5].numpy(), np.asarray(jout[5]))
    for i in (0, 1, 2, 3, 4, 6):
        np.testing.assert_allclose(tout[i].numpy(), np.asarray(jout[i]),
                                   atol=2e-5, rtol=0)


def _decode_inputs(B=3, t_in=6, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, 4, 10)).astype(np.float32)
    ex = rng.integers(4, 30, (B, t_in)).astype(np.int32)
    ln = rng.integers(2, t_in + 1, (B,)).astype(np.int32)
    return feats, ex, ln


@pytest.mark.parametrize("cell_impl", ["xla", "pallas", "wholestep"])
@pytest.mark.parametrize("arch", ["editnet", "dcnet"])
def test_fp32_beam10_decode_identical_to_jax(arch, cell_impl):
    """compute_dtype="float32", beam_size = 10 (k = 10 > 8) through every
    cell path: the register beam search gives JAX's tokens, scores within
    2e-4."""
    kw = dict(CFG, arch=arch, compute_dtype="float32", cell_impl=cell_impl)
    jm, tm = jax_get_model(JaxModelConfig(**kw)), get_model(ModelConfig(**kw))
    jp = jm.init(jax.random.PRNGKey(5))
    tp = (editnet_params_from_numpy if arch == "editnet"
          else dcnet_params_from_numpy)(_arrays(jp), "cpu")
    feats, ex, ln = _decode_inputs()
    jctx = jm.encode(jp, jnp.asarray(feats), jnp.asarray(ex), jnp.asarray(ln))
    tctx = tm.encode(tp, torch.from_numpy(feats), torch.from_numpy(ex).long(),
                     torch.from_numpy(ln).long())
    bk = dict(beam_size=10, start_id=2, end_id=3, max_len=6)
    j = jax_beam_search(jm, jp, jctx, impl="register", **bk)
    t = beam_search(tm, tp, tctx, **bk)
    np.testing.assert_array_equal(t.tokens.numpy(), np.asarray(j.tokens))
    np.testing.assert_allclose(t.scores.numpy(), np.asarray(j.scores),
                               rtol=2e-4, atol=2e-4)
