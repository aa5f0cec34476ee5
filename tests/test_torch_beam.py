"""The port's beam search (``captionkit_torch.decode.beam``) against
``captionkit.decode.beam`` (``impl="register"``) on the CPU, on the same
weights and inputs.

At fp32, tokens, the n-best list and lengths must be identical and scores
within atol 1e-4 (fp32 sums of log-probs over up to 8 steps, each step's
logits agreeing to ~1e-6). The end id is made reachable by raising its
bias, so beams finish early and the finished-hypothesis register decides
the result; ``end_id=-1`` runs every step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionkit.decode.beam import beam_search as jax_beam_search
from captionkit.models import get_model as jax_get_model
from captionkit.utils.config import ModelConfig as JaxModelConfig

from captionkit_torch.config import ModelConfig
from captionkit_torch.decode.beam import beam_search
from captionkit_torch.models import get_model
from captionkit_torch.params import editnet_params_from_numpy

SMALL = dict(vocab_size=40, emb_dim=16, hidden_dim=24, att_dim=8,
             feat_dim=12, num_regions=5, dropout=0.0)
END, START, MAX_LEN = 3, 2, 8


def _setup(dtype="float32", **kw):
    jcfg = JaxModelConfig(arch="editnet", compute_dtype=dtype, **SMALL, **kw)
    jm = jax_get_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    jp = jp.replace(fc_b=jp.fc_b.at[END].add(2.5))  # <end> within MAX_LEN
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    arrays = {"/".join(str(getattr(k, "name", k)) for k in path):
              np.asarray(leaf) for path, leaf in flat}
    tm = get_model(ModelConfig(arch="editnet", compute_dtype=dtype,
                               **SMALL, **kw))
    return jm, jp, tm, editnet_params_from_numpy(arrays, "cpu")


def _run(jm, jp, tm, tp, **kw):
    rng = np.random.default_rng(0)
    B, T = 4, 7
    feats = rng.standard_normal((B, 5, 12)).astype(np.float32)
    ex = rng.integers(4, 40, (B, T)).astype(np.int32)
    ln = rng.integers(2, T + 1, (B,)).astype(np.int32)
    jctx = jm.encode(jp, jnp.asarray(feats), jnp.asarray(ex), jnp.asarray(ln))
    tctx = tm.encode(tp, torch.from_numpy(feats), torch.from_numpy(ex).long(),
                     torch.from_numpy(ln).long())
    kw = dict(start_id=START, max_len=MAX_LEN, **kw)
    return (jax_beam_search(jm, jp, jctx, impl="register", **kw),
            beam_search(tm, tp, tctx, **kw))


def _assert_identical(j, t, atol=1e-4):
    for f in ("tokens", "lengths", "all_tokens", "all_lengths"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    for f in ("scores", "all_scores"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), atol=atol,
                                   rtol=0, err_msg=f)


@pytest.mark.parametrize("K,end_id,length_penalty", [
    (1, END, 0.0), (1, -1, 0.0), (3, END, 0.7), (3, -1, 0.0),
    (5, END, 0.0), (5, -1, 0.0),
])
def test_beam_search_identical_to_jax_fp32(K, end_id, length_penalty):
    j, t = _run(*_setup(), beam_size=K, end_id=end_id,
                length_penalty=length_penalty)
    _assert_identical(j, t)
    assert tuple(t.all_tokens.shape) == (4, K, MAX_LEN)
    if end_id == -1:
        assert bool((t.all_lengths == MAX_LEN).all())
    else:  # some hypotheses finished early: the register path ran
        assert bool((t.lengths < MAX_LEN).any())
        assert bool((t.tokens == END).any())


def test_beam_search_full_logits_path_identical():
    """use_fused_head=False: log_softmax over the full [B*K, V] logits."""
    j, t = _run(*_setup(use_fused_head=False), beam_size=5, end_id=END)
    _assert_identical(j, t)


def test_beam_search_bf16_identical():
    """bf16 products with fp32 results, rounded where the reference
    rounds: the same captions (scores within 1e-3)."""
    j, t = _run(*_setup("bfloat16"), beam_size=5, end_id=END)
    _assert_identical(j, t, atol=1e-3)


def test_beam_impl_backptr_not_ported():
    jm, jp, tm, tp = _setup()
    ctx = tm.encode(tp, torch.zeros((1, 5, 12)),
                    torch.zeros((1, 3), dtype=torch.long),
                    torch.ones((1,), dtype=torch.long))
    # Ported since: the backpointer layout gives the register's result.
    bp = beam_search(tm, tp, ctx, beam_size=2, start_id=START, end_id=END,
                     impl="backptr")
    reg = beam_search(tm, tp, ctx, beam_size=2, start_id=START, end_id=END)
    for f in bp._fields:
        assert torch.equal(getattr(bp, f), getattr(reg, f)), f
    with pytest.raises(ValueError):
        beam_search(tm, tp, ctx, beam_size=2, start_id=START, end_id=END,
                    impl="other")
