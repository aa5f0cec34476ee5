"""The port's attention introspection (``captionkit_torch.decode.
introspect`` and the models' ``step_attn``) against ``captionkit.decode.
introspect`` on the CPU: the same weights (JAX inits, bridged by name),
the same synthetic split, fp32.

Tolerances: tokens and masks identical; attention distributions, scores
and log-probs within 1e-5 of JAX's (fp32 sums in other orders). Against
the port's own decodes: the greedy trace's tokens equal ``greedy_decode``'s
and the beam trace's result is bit-equal to ``beam_search`` over the full
logits (``use_fused_head=False``), under both history layouts.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionkit.data import SyntheticCaptionSource as JaxSource
from captionkit.decode import greedy_decode_with_attention as j_greedy_attn
from captionkit.decode.introspect import attention_report as j_report
from captionkit.decode.introspect import beam_decode_with_attention as j_beam_attn
from captionkit.models import ensemble_model as j_ensemble
from captionkit.models import get_model as jax_get_model
from captionkit.models import stack_params as j_stack
from captionkit.utils.config import ModelConfig as JaxModelConfig

from captionkit_torch.config import ModelConfig
from captionkit_torch.data import SyntheticCaptionSource
from captionkit_torch.decode import (
    AttentionTrace,
    attention_report,
    beam_decode_with_attention,
    beam_search,
    greedy_decode,
    greedy_decode_with_attention,
)
from captionkit_torch.decode.greedy import Rollout
from captionkit_torch.models import get_model
from captionkit_torch.models.ensemble import ensemble_model, stack_params
from captionkit_torch.params import (
    dcnet_params_from_numpy,
    editnet_params_from_numpy,
)

SRC = dict(num_images=6, captions_per_image=2, num_regions=4, feat_dim=12,
           max_len=12, seed=0)


def _flat(jp):
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    return {"/".join(str(getattr(k, "name", k)) for k in path):
            np.asarray(leaf) for path, leaf in flat if leaf is not None}


def _bridge(arch, jp):
    fn = (editnet_params_from_numpy if arch == "editnet"
          else dcnet_params_from_numpy)
    return fn(_flat(jp), "cpu")


@functools.lru_cache(maxsize=None)
def _setup(arch, seeds=(0,), visual=False):
    """(vocab, existing ids of the eval view, (JAX model, params, ctx),
    (port model, params, ctx)), an ensemble of the seeds' members when
    several; ``visual``: DCNet's visual variant. Built once a process and
    read only by the tests."""
    jsrc, src = JaxSource(**SRC), SyntheticCaptionSource(**SRC)
    assert src.vocab.word2id == jsrc.vocab.word2id
    dims = dict(arch=arch, vocab_size=len(src.vocab), emb_dim=16,
                hidden_dim=24, att_dim=8, feat_dim=12, num_regions=4,
                dropout=0.0, compute_dtype="float32",
                dcnet_use_visual=visual)
    jm, tm = jax_get_model(JaxModelConfig(**dims)), get_model(
        ModelConfig(**dims))
    jps = [jm.init(jax.random.PRNGKey(s)) for s in seeds]
    tps = [_bridge(arch, p) for p in jps]
    ds = src.eval_view()
    feats = np.asarray(ds.features, np.float32)
    visual = arch == "editnet" or visual
    existing = np.asarray(ds.existing, np.int32)
    lens = np.asarray(ds.existing_len, np.int32)
    if len(seeds) > 1:
        jm, tm = j_ensemble(jm, len(seeds)), ensemble_model(tm, len(seeds))
        jps, tps = [j_stack(jps)], [stack_params(tps)]
    jctx = jm.encode(jps[0], jnp.asarray(feats) if visual else None,
                     jnp.asarray(existing), jnp.asarray(lens))
    tctx = tm.encode(tps[0], torch.from_numpy(feats) if visual else None,
                     torch.from_numpy(existing).long(),
                     torch.from_numpy(lens).long())
    return src.vocab, existing, (jm, jps[0], jctx), (tm, tps[0], tctx)


def _ids(vocab, max_len):
    return dict(start_id=vocab.start, end_id=vocab.end, pad_id=vocab.pad,
                max_len=max_len)


@functools.lru_cache(maxsize=None)
def _jax_greedy(arch, max_len, visual=False):
    vocab, _, (jm, jp, jctx), _ = _setup(arch, visual=visual)
    return j_greedy_attn(jm, jp, jctx, **_ids(vocab, max_len))


@functools.lru_cache(maxsize=None)
def _jax_beam(arch, length_penalty=0.0, seeds=(0,), max_len=9):
    vocab, _, (jm, jp, jctx), _ = _setup(arch, seeds)
    return j_beam_attn(jm, jp, jctx, beam_size=3,
                       length_penalty=length_penalty,
                       **_ids(vocab, max_len))


def _close_attention(got, want, atol=1e-5):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=atol, rtol=0, err_msg=key)


@pytest.mark.parametrize("arch", ["editnet", "dcnet"])
def test_attention_trace_matches_plain_greedy(arch):
    vocab, _, _, (tm, tp, tctx) = _setup(arch)
    kw = _ids(vocab, 8)
    plain = greedy_decode(tm, tp, tctx, **kw)
    trace = greedy_decode_with_attention(tm, tp, tctx, **kw)
    for field in Rollout._fields:
        assert torch.equal(getattr(plain, field),
                           getattr(trace.rollout, field)), field
    jtrace = _jax_greedy(arch, 8)
    np.testing.assert_array_equal(trace.rollout.tokens.numpy(),
                                  np.asarray(jtrace.rollout.tokens))
    np.testing.assert_array_equal(trace.rollout.mask.numpy(),
                                  np.asarray(jtrace.rollout.mask))
    _close_attention(trace.attention, jtrace.attention)


def test_editnet_attention_distributions_are_valid():
    vocab, existing, (_, _, jctx), (tm, tp, tctx) = _setup("editnet")
    trace = greedy_decode_with_attention(tm, tp, tctx, **_ids(vocab, 8))
    assert set(trace.attention) == {"vis_alpha", "beta"}
    alpha = trace.attention["vis_alpha"].numpy()  # [B, L, R]
    beta = trace.attention["beta"].numpy()  # [B, L, T]
    B, L = trace.rollout.tokens.shape
    assert alpha.shape == (B, L, 4)
    assert beta.shape == (B, L, existing.shape[1])
    np.testing.assert_allclose(alpha.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(beta.sum(-1), 1.0, atol=1e-5)
    lens = np.asarray(jctx.mask).sum(-1)
    for b in range(B):
        assert (beta[b, :, lens[b]:] == 0.0).all()  # masked: exactly 0
    _close_attention(trace.attention, _jax_greedy("editnet", 8).attention)


def test_dcnet_alpha_masked_and_visual_variant():
    vocab, _, (_, _, jctx), (tm, tp, tctx) = _setup("dcnet")
    trace = greedy_decode_with_attention(tm, tp, tctx, **_ids(vocab, 8))
    assert set(trace.attention) == {"alpha"}
    alpha = trace.attention["alpha"].numpy()
    lens = np.asarray(jctx.mask).sum(-1)
    for b in range(alpha.shape[0]):
        assert (alpha[b, :, lens[b]:] == 0.0).all()
    _close_attention(trace.attention, _jax_greedy("dcnet", 8).attention)
    vocab, _, _, (tm, tp, tctx) = _setup("dcnet", visual=True)
    tr2 = greedy_decode_with_attention(tm, tp, tctx, **_ids(vocab, 6))
    assert set(tr2.attention) == {"alpha", "vis_alpha"}
    _close_attention(tr2.attention,
                     _jax_greedy("dcnet", 6, visual=True).attention)


def _check_beam_trace(arch, impl, length_penalty):
    vocab, _, _, (tm, tp, tctx) = _setup(arch)
    kw = dict(beam_size=3, length_penalty=length_penalty, **_ids(vocab, 9))
    trace = beam_decode_with_attention(tm, tp, tctx, **kw)
    # Bit-equal to the port's beam search over the full logits.
    full = get_model(ModelConfig(
        arch=arch, vocab_size=len(vocab), emb_dim=16, hidden_dim=24,
        att_dim=8, feat_dim=12, num_regions=4, dropout=0.0,
        compute_dtype="float32", use_fused_head=False))
    ref = beam_search(full, tp, tctx, impl=impl, **kw)
    for field in ref._fields:
        assert torch.equal(getattr(ref, field),
                           getattr(trace.result, field)), field
    # The fused-head decode: the same tokens.
    fused = beam_search(tm, tp, tctx, impl=impl, **kw)
    assert torch.equal(fused.tokens, trace.result.tokens)
    torch.testing.assert_close(fused.scores, trace.result.scores,
                               atol=1e-5, rtol=0)
    assert torch.equal(trace.rollout.tokens, trace.result.tokens)
    # Raw-sum ranking: the winner path's log-probs sum to its score.
    if length_penalty == 0.0:
        torch.testing.assert_close(trace.rollout.logprobs.sum(-1),
                                   trace.result.scores, atol=1e-4, rtol=0)
    # Against JAX's trace (which tests/test_introspect.py pins to JAX's
    # beam_search under both layouts).
    jtrace = _jax_beam(arch, length_penalty)
    np.testing.assert_array_equal(trace.result.all_tokens.numpy(),
                                  np.asarray(jtrace.result.all_tokens))
    np.testing.assert_array_equal(trace.result.lengths.numpy(),
                                  np.asarray(jtrace.result.lengths))
    np.testing.assert_allclose(trace.result.scores.numpy(),
                               np.asarray(jtrace.result.scores), atol=1e-5)
    np.testing.assert_allclose(trace.rollout.logprobs.numpy(),
                               np.asarray(jtrace.rollout.logprobs),
                               atol=1e-5)
    _close_attention(trace.attention, jtrace.attention)


@pytest.mark.parametrize("arch", ["editnet", "dcnet"])
@pytest.mark.parametrize("impl", ["register", "backptr"])
def test_beam_attention_matches_beam_search(arch, impl):
    _check_beam_trace(arch, impl, 0.0)


@pytest.mark.parametrize("impl", ["register", "backptr"])
def test_beam_attention_matches_length_penalty_variant(impl):
    _check_beam_trace("editnet", impl, 0.7)


def test_beam_attention_winner_path_replay():
    """Replaying the winner's token prefix through step_attn one image at
    a time reproduces the trace's gathered attention; masked steps are
    exactly zero."""
    vocab, _, _, (tm, tp, tctx) = _setup("editnet")
    trace = beam_decode_with_attention(tm, tp, tctx, beam_size=3,
                                       **_ids(vocab, 9))
    _close_attention(trace.attention, _jax_beam("editnet").attention)
    tokens = trace.rollout.tokens
    lengths = trace.rollout.lengths
    for b in range(3):
        ctx1 = tctx.replace(**{
            f: getattr(tctx, f)[b:b + 1] for f in (
                "features", "vis_keys", "v_mean", "att_zv", "enc_hs",
                "enc_cs", "scma_keys", "mask")})
        state = tm.init_state(tp, ctx1)
        tok = torch.tensor([vocab.start], dtype=torch.int32)
        for t in range(int(lengths[b])):
            state, _, attn = tm.step_attn(tp, ctx1, state, tok)
            for key, arr in trace.attention.items():
                torch.testing.assert_close(
                    arr[b, t], attn[key][0], atol=1e-6, rtol=0,
                    msg=f"image {b} step {t} key {key}")
            tok = tokens[b, t:t + 1]
        for arr in trace.attention.values():
            assert (arr[b, int(lengths[b]):] == 0.0).all()


def test_beam_attention_ensemble_mean():
    """The ensemble traces its members' MEAN attention: replaying the
    ensemble's greedy tokens through each member gives it."""
    vocab, _, _, (tm, tp, tctx) = _setup("editnet", seeds=(0, 7))
    kw = dict(beam_size=3, **_ids(vocab, 8))
    trace = beam_decode_with_attention(tm, tp, tctx, **kw)
    ref = beam_search(tm, tp, tctx, **kw)
    assert torch.equal(ref.tokens, trace.result.tokens)
    jtrace = _jax_beam("editnet", seeds=(0, 7), max_len=8)
    np.testing.assert_array_equal(trace.result.tokens.numpy(),
                                  np.asarray(jtrace.result.tokens))
    _close_attention(trace.attention, jtrace.attention)
    beta = trace.attention["beta"]
    for b in range(beta.shape[0]):
        n = int(trace.rollout.lengths[b])
        if n:
            torch.testing.assert_close(beta[b, :n].sum(-1),
                                       torch.ones(n), atol=1e-5, rtol=0)
    greedy = greedy_decode_with_attention(tm, tp, tctx, **_ids(vocab, 8))
    member = get_model(ModelConfig(
        arch="editnet", vocab_size=len(vocab), emb_dim=16, hidden_dim=24,
        att_dim=8, feat_dim=12, num_regions=4, dropout=0.0,
        compute_dtype="float32"))
    per_member = []
    for p, c in zip(tp.members, tctx.members):
        state = member.init_state(p, c)
        tok = torch.full((beta.shape[0],), vocab.start, dtype=torch.int32)
        steps = []
        for t in range(8):
            state, _, attn = member.step_attn(p, c, state, tok)
            steps.append(attn)
            tok = greedy.rollout.tokens[:, t]
        per_member.append({k: torch.stack([s[k] for s in steps], dim=1)
                           for k in steps[0]})
    for key, arr in greedy.attention.items():
        mean = (per_member[0][key] + per_member[1][key]) / 2
        torch.testing.assert_close(arr, mean, atol=1e-6, rtol=0)


def test_attention_report_is_readable():
    vocab, existing, _, (tm, tp, tctx) = _setup("editnet")
    trace = greedy_decode_with_attention(tm, tp, tctx, **_ids(vocab, 8))
    jtrace = _jax_greedy("editnet", 8)
    rep = attention_report(trace, 0, vocab, existing[0])
    want = j_report(jtrace, 0, vocab, existing[0])
    assert rep, "no steps in report"
    assert len(rep) == len(want)
    for got, ref in zip(rep, want):
        assert got.keys() == ref.keys()
        for key in ref:
            if key.endswith("_weight"):
                assert abs(got[key] - ref[key]) <= 1e-5
            else:
                assert got[key] == ref[key], key
        assert isinstance(got["word"], str)
        assert "beta_word" in got and "vis_alpha_argmax" in got
        assert "vis_alpha_word" not in got  # regions never words
        assert 0.0 <= got["beta_weight"] <= 1.0
    # On the same trace the two reports are equal, record for record.
    same = AttentionTrace(
        rollout=Rollout(*(torch.from_numpy(np.array(x))
                          for x in jtrace.rollout)),
        attention={k: torch.from_numpy(np.array(v))
                   for k, v in jtrace.attention.items()})
    assert attention_report(same, 0, vocab, existing[0]) == want
