"""The port's SCST step (``captionkit_torch.train.scst``) against the JAX
reference on the CPU: the same tiny synthetic batch on both sides, the
same initial weights (bridged by name), fp32, dropout 0.

Tolerances: greedy tokens identical; a sampled token's log-prob within
1e-5 of its teacher-forced log-prob (the same arithmetic in another
order); advantages within 1e-6 of JAX's (float32 casts of the same
float64 CIDEr-D) and the native rewards within 1e-9 of the Python
``CiderD``; one update's loss, gradient norm and parameters within 1e-5
of JAX's (fp32 sums in other orders, one Adam step with the element
clip).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionkit.data import SyntheticCaptionSource as JSource
from captionkit.metrics.cider import NgramDocFreq as JDocFreq
from captionkit.models import get_model as jax_get_model
from captionkit.train.scst import ScstRewarder as JRewarder
from captionkit.train.scst import make_scst_rollout as j_rollout
from captionkit.train.scst import make_scst_update as j_update
from captionkit.train.state import create_train_state as j_create_state
from captionkit.train.xe import batch_to_device_dict as j_batch
from captionkit.utils.config import CaptionKitConfig as JaxConfig

from captionkit_torch.config import CaptionKitConfig
from captionkit_torch.data import SyntheticCaptionSource
from captionkit_torch.decode.greedy import sample_decode
from captionkit_torch.metrics.cider import CiderD, NgramDocFreq
from captionkit_torch.models import get_model
from captionkit_torch.models.base import teacher_forcing_logits
from captionkit_torch.params import named_tensors, params_from_tensors
from captionkit_torch.train import scst
from captionkit_torch.train.state import create_train_state
from captionkit_torch.train.xe import batch_to_device_dict

R, F, L = 4, 12, 8
SRC = dict(num_images=8, captions_per_image=2, num_regions=R, feat_dim=F,
           max_len=12, seed=5)
OVER = {"model.emb_dim": 16, "model.hidden_dim": 24, "model.att_dim": 8,
        "model.feat_dim": F, "model.num_regions": R, "model.dropout": 0.0,
        "model.compute_dtype": "float32", "train.grad_clip": 0.1,
        "train.learning_rate": 1e-2, "train.donate_state": False,
        "train.ema_decay": 0.5}


def _flat(jp):
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    return {"/".join(str(getattr(k, "name", k)) for k in path):
            np.asarray(leaf) for path, leaf in flat if leaf is not None}


def _setup(arch="editnet"):
    jsrc, tsrc = JSource(**SRC), SyntheticCaptionSource(**SRC)
    over = {**OVER, "model.arch": arch, "model.vocab_size": len(tsrc.vocab)}
    jcfg, tcfg = JaxConfig().override(over), CaptionKitConfig().override(
        {k: v for k, v in over.items() if k != "train.donate_state"})
    jm, tm = jax_get_model(jcfg.model), get_model(tcfg.model)
    jp = jm.init(jax.random.PRNGKey(4))
    like = tm.init(0, "cpu")
    js = j_create_state(lambda k: jp, jcfg.train)
    ts = create_train_state(lambda seed: params_from_tensors(
        {n: torch.from_numpy(a.copy()) for n, a in _flat(jp).items()},
        like), tcfg.train)
    hb = next(tsrc.dataset.batches(6))
    return (jsrc, jcfg, jm, js, j_batch(next(jsrc.dataset.batches(6)))), \
        (tsrc, tcfg, tm, ts, batch_to_device_dict(hb, "cpu"), hb)


def _ids(v):
    return dict(start_id=v.start, end_id=v.end, pad_id=v.pad, max_len=L)


@pytest.mark.parametrize("arch", ["editnet", "dcnet"])
def test_greedy_leg_matches_jax_rollout(arch):
    (jsrc, _, jm, js, jb), (tsrc, _, tm, ts, tb, _) = _setup(arch)
    want = j_rollout(jm, **_ids(jsrc.vocab))(js.params, jb,
                                             jax.random.PRNGKey(0))
    roll = scst.make_scst_rollout(tm, **_ids(tsrc.vocab))(
        ts.params, tb, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(roll["greedy_tokens"].numpy(),
                                  np.asarray(want["greedy_tokens"]))
    np.testing.assert_array_equal(roll["greedy_mask"].numpy(),
                                  np.asarray(want["greedy_mask"]))
    np.testing.assert_array_equal(scst.host_tokens(roll, "greedy_tokens"),
                                  np.asarray(want["greedy_tokens"]))
    assert roll["sample_tokens"].shape == (6, L)
    assert roll["ready"] is None


def test_sampled_logprobs_are_the_teacher_forced_ones():
    """A sample's log-probs (the rollout's) equal the log-probs teacher
    forcing gives the same tokens, which is what the update
    differentiates; the same generator state gives the same samples."""
    _, (tsrc, _, tm, ts, tb, _) = _setup()
    v = tsrc.vocab
    with torch.no_grad():
        ctx = tm.encode(ts.params, tb["features"], tb["existing"],
                        tb["existing_len"])
        draw = [sample_decode(tm, ts.params, ctx,
                              torch.Generator().manual_seed(7), **_ids(v))
                for _ in range(2)]
        assert torch.equal(draw[0].tokens, draw[1].tokens)
        toks = draw[0].tokens
        tokens_in = torch.cat([torch.full((6, 1), v.start, dtype=toks.dtype),
                               toks[:, :-1]], dim=1)
        logits = teacher_forcing_logits(tm, ts.params, ctx,
                                        tm.init_state(ts.params, ctx),
                                        tokens_in)
        tf = torch.gather(torch.log_softmax(logits, -1), 2,
                          toks.long()[..., None])[..., 0]
    m = draw[0].mask
    np.testing.assert_allclose(tf[m].numpy(), draw[0].logprobs[m].numpy(),
                               atol=1e-5, rtol=0)
    other = scst.make_scst_rollout(tm, num_samples=2, **_ids(v))(
        ts.params, tb, torch.Generator().manual_seed(8))
    assert other["sample_tokens"].shape == (2, 6, L)
    assert "greedy_tokens" not in other


def test_rollout_builds_no_autograd_graph():
    """The trainable parameters require grad, but the rollout runs under
    no_grad: nothing it returns carries a graph."""
    _, (tsrc, _, tm, ts, tb, _) = _setup()
    assert all(t.requires_grad for t in named_tensors(ts.params).values())
    for n in (1, 2):
        roll = scst.make_scst_rollout(tm, num_samples=n, **_ids(tsrc.vocab))(
            ts.params, tb, torch.Generator().manual_seed(1))
        for key in ("sample_tokens", "sample_mask"):
            assert roll[key].grad_fn is None
            assert not roll[key].requires_grad


def _refs(src, hb):
    return [src.dataset.references[int(i)] for i in hb.image_id]


def test_advantages_match_jax_rewarder():
    (jsrc, *_), (tsrc, _, _, _, _, hb) = _setup()
    refs = _refs(tsrc, hb)
    rng = np.random.default_rng(0)
    words = len(tsrc.vocab)
    tok = rng.integers(4, words, (3, 6, L)).astype(np.int32)
    tok[:, :, 5:] = tsrc.vocab.pad
    tok[:, :3, 4] = tsrc.vocab.end
    tok[1, 0] = tok[0, 0]  # a sample equal to its sibling
    jr = JRewarder(jsrc.vocab, JDocFreq.build(jsrc.dataset.references))
    tr = scst.ScstRewarder(tsrc.vocab,
                           NgramDocFreq.build(tsrc.dataset.references))
    ids = tr.intern(refs)
    np.testing.assert_allclose(tr.advantage(tok[0], tok[1], ids),
                               jr.advantage(tok[0], tok[1], refs),
                               atol=1e-6, rtol=0)
    got, got_r = tr.advantage_loo(tok, ids)
    want, want_r = jr.advantage_loo(tok, refs)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_r, want_r, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.sum(axis=0), 0.0, atol=1e-5)
    hyps = [tsrc.vocab.decode(r) for r in tok.reshape(18, L)]
    _, py = CiderD(NgramDocFreq.build(tsrc.dataset.references)).compute(
        hyps, refs * 3)
    np.testing.assert_allclose(tr._native.score(hyps, refs * 3), py,
                               atol=1e-9, rtol=0)
    with pytest.raises(ValueError, match="num_samples >= 2"):
        tr.advantage_loo(tok[:1], ids)


def test_reward_scoring_is_bit_equal_to_one_set_at_a_time():
    """``NativeCiderD.score_sets`` (the references interned once by
    ``ScstRewarder.intern``, their vectors built once for every set)
    against a fresh scorer scoring each set alone, in order, with fresh
    copies of the references (so every token is interned again): the same
    float64 scores, bit for bit, on a first call and on a second one with
    the same ids; within 1e-9 of the reference's native scorer; the
    rewarder's array decode equals ``Vocab.decode`` row by row."""
    from captionkit.metrics import fast as jfast

    from captionkit_torch.metrics.fast import NativeCiderD

    (jsrc, *_), (tsrc, _, _, _, _, hb) = _setup()
    refs = _refs(tsrc, hb)
    rng = np.random.default_rng(1)
    tok = rng.integers(0, len(tsrc.vocab), (3, 6, L)).astype(np.int32)
    tok[:, :2, 3] = tsrc.vocab.end
    tok[2, 4] = tsrc.vocab.pad
    df = NgramDocFreq.build(tsrc.dataset.references)
    rw = scst.ScstRewarder(tsrc.vocab, df)
    hyps = [rw._decode(t) for t in tok]
    assert hyps == [[tsrc.vocab.decode(r) for r in t] for t in tok]
    alone = NativeCiderD(df)
    want = np.stack([alone.score(h, [list(r) for r in refs]) for h in hyps])
    ids = rw.intern(refs)
    for _ in range(2):
        got = rw._native.score_sets(hyps, ids)
        assert got.dtype == np.float64 and np.array_equal(got, want)
    j_native = jfast.NativeCiderD(JDocFreq(dict(df.df), df.corpus_size,
                                           df.max_n))
    for h, w in zip(hyps, want):
        np.testing.assert_allclose(j_native.score(h, refs), w, atol=1e-9,
                                   rtol=0)
    assert np.array_equal(rw.advantage(tok[0], tok[1], ids),
                          (want[0] - want[1]).astype(np.float32))


@pytest.mark.parametrize("arch,n", [("editnet", 1), ("editnet", 3),
                                    ("dcnet", 1), ("dcnet", 3)])
def test_update_matches_jax(arch, n):
    """One update on the same sampled tokens, masks and advantages: the
    loss, the metrics, the gradient norm and every parameter (and EMA)
    after the step. EditNet's teacher forcing runs the deferred backward,
    DCNet's autograd through its loop."""
    (jsrc, jcfg, jm, js, jb), (tsrc, tcfg, tm, ts, tb, _) = _setup(arch)
    roll = j_rollout(jm, num_samples=max(n, 2), **_ids(jsrc.vocab))(
        js.params, jb, jax.random.PRNGKey(2))
    toks = np.array(roll["sample_tokens"])[:n]
    mask = np.array(roll["sample_mask"])[:n]
    adv = np.random.default_rng(n).standard_normal((n, 6)).astype(
        np.float32)
    if n == 1:
        toks, mask, adv = toks[0], mask[0], adv[0]
    jb = dict(jb, valid=jnp.asarray([True] * 5 + [False]))
    tb = dict(tb, valid=torch.tensor([True] * 5 + [False]))
    js2, jm_ = j_update(jm, jcfg.train, start_id=jsrc.vocab.start,
                        num_samples=n)(js, jb, jnp.asarray(toks),
                                       jnp.asarray(mask), jnp.asarray(adv))
    ts2, tm_ = scst.make_scst_update(tm, tcfg.train,
                                     start_id=tsrc.vocab.start,
                                     num_samples=n)(
        ts, tb, torch.from_numpy(toks), torch.from_numpy(mask),
        torch.from_numpy(adv))
    assert ts2.step == 1
    for key in ("scst_loss", "mean_advantage", "sample_len", "grad_norm"):
        np.testing.assert_allclose(float(tm_[key]), float(jm_[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    jflat = _flat(js2.params)
    for name, t in named_tensors(ts2.params).items():
        np.testing.assert_allclose(t.detach().numpy(), jflat[name],
                                   atol=1e-5, rtol=0, err_msg=name)
    jema = _flat(js2.opt_state)
    ema = ts2.opt_state.ema
    for name in ("fc_w", "embedding"):
        want = [v for k, v in jema.items() if k.endswith(name)
                and v.shape == ema[name].shape]
        assert any(np.allclose(ema[name].numpy(), w, atol=1e-5, rtol=0)
                   for w in want), name


def test_equal_rewards_give_a_zero_gradient():
    """Every sample of an image earning the same reward makes each
    leave-one-out advantage exactly zero: the update's gradient is zero
    and the parameters move by Adam's zero update."""
    _, (tsrc, tcfg, tm, ts, tb, hb) = _setup()
    v = tsrc.vocab
    rw = scst.ScstRewarder(v, NgramDocFreq.build(tsrc.dataset.references))
    ids = rw.intern(_refs(tsrc, hb))

    class Const:
        def score_sets(self, hyp_sets, refs):
            return np.ones((len(hyp_sets), len(refs)), np.float64)

    rw._native = Const()
    before = {n: t.detach().clone()
              for n, t in named_tensors(ts.params).items()}
    state, metrics = scst.scst_train_step(
        rollout_fn=scst.make_scst_rollout(tm, num_samples=2, **_ids(v)),
        update_fn=scst.make_scst_update(tm, tcfg.train, start_id=v.start,
                                        num_samples=2),
        rewarder=rw, state=ts, batch=tb, references=ids,
        generator=torch.Generator().manual_seed(3))
    assert float(metrics["grad_norm"]) == 0.0
    assert float(metrics["mean_advantage"]) == 0.0
    assert metrics["reward_sample_mean"] == 1.0
    for n, t in named_tensors(state.params).items():
        assert torch.equal(t.detach(), before[n]), n


def test_update_moves_logprobs_in_the_advantage_direction():
    """The REINFORCE sign: a positive advantage raises the sampled
    tokens' log-probs, a negative one lowers them."""
    _, (tsrc, tcfg, tm, _, tb, _) = _setup()
    v = tsrc.vocab
    fresh = _setup()[1][3]
    roll = scst.make_scst_rollout(tm, **_ids(v))(
        fresh.params, tb, torch.Generator().manual_seed(5))

    def mean_logp(params):
        with torch.no_grad():
            ctx = tm.encode(params, tb["features"], tb["existing"],
                            tb["existing_len"])
            toks = roll["sample_tokens"]
            tokens_in = torch.cat([torch.full((6, 1), v.start,
                                              dtype=toks.dtype),
                                   toks[:, :-1]], dim=1)
            lp = torch.log_softmax(teacher_forcing_logits(
                tm, params, ctx, tm.init_state(params, ctx), tokens_in), -1)
            tl = torch.gather(lp, 2, toks.long()[..., None])[..., 0]
            m = roll["sample_mask"].float()
            return float((tl * m).sum() / m.sum())

    before = mean_logp(fresh.params)
    for sign in (1.0, -1.0):
        st = _setup()[1][3]
        st, _ = scst.make_scst_update(tm, tcfg.train, start_id=v.start)(
            st, tb, roll["sample_tokens"], roll["sample_mask"],
            torch.full((6,), sign))
        assert (mean_logp(st.params) - before) * sign > 0
