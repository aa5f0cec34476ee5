"""The port's backpointer beam search (``beam_search(impl="backptr")``)
against ``captionkit.decode.beam`` (``impl="backptr"``) and against the
port's own ``impl="register"`` on the CPU, on the same weights (JAX init,
carried over by the flat-name bridge) and the same numpy inputs.

At fp32, tokens, the n-best list and lengths must be identical to JAX and
scores within atol 1e-4 (fp32 sums of log-probs over up to 8 steps, each
step's logits agreeing to ~1e-6); against the port's register layout,
which runs the same arithmetic, everything is bit-equal. The end id's
head column is scaled and its bias moved (``END_LOGIT``), so beams finish
at different steps, some images finish nothing, and the
finished-hypothesis register and the backpointer walk decide the result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionkit.decode.beam import _reconstruct as jax_reconstruct
from captionkit.decode.beam import beam_search as jax_beam_search
from captionkit.models import get_model as jax_get_model
from captionkit.utils.config import ModelConfig as JaxModelConfig

from captionkit_torch.config import ModelConfig
from captionkit_torch.decode.beam import _reconstruct, beam_search
from captionkit_torch.models import get_model
from captionkit_torch.params import (
    dcnet_params_from_numpy,
    editnet_params_from_numpy,
)

SMALL = dict(vocab_size=40, emb_dim=16, hidden_dim=24, att_dim=8,
             feat_dim=12, num_regions=5, dropout=0.0,
             compute_dtype="float32")
END, START, MAX_LEN = 3, 2, 8
# (scale of the end id's head column, shift of its bias) per arch: the
# end logit then depends on the state enough that beams of one image
# finish at different steps (these random weights give near-flat logits).
END_LOGIT = {"editnet": (100.0, -1.0), "dcnet": (1.0, 0.1)}


def _setup(arch, **kw):
    cfg = dict(SMALL, arch=arch, **kw)
    jm = jax_get_model(JaxModelConfig(**cfg))
    jp = jm.init(jax.random.PRNGKey(3))
    scale, shift = END_LOGIT[arch]
    jp = jp.replace(fc_w=jp.fc_w.at[:, END].multiply(scale),
                    fc_b=jp.fc_b.at[END].add(shift))
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    arrays = {"/".join(str(getattr(k, "name", k)) for k in path):
              np.asarray(leaf) for path, leaf in flat if leaf is not None}
    bridge = (editnet_params_from_numpy if arch == "editnet"
              else dcnet_params_from_numpy)
    return jm, jp, get_model(ModelConfig(**cfg)), bridge(arrays, "cpu")


def _contexts(jm, jp, tm, tp, B=6, T=7):
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((B, 5, 12)).astype(np.float32)
    ex = rng.integers(4, 40, (B, T)).astype(np.int32)
    ln = rng.integers(2, T + 1, (B,)).astype(np.int32)
    jctx = jm.encode(jp, jnp.asarray(feats), jnp.asarray(ex), jnp.asarray(ln))
    tctx = tm.encode(tp, torch.from_numpy(feats), torch.from_numpy(ex).long(),
                     torch.from_numpy(ln).long())
    return jctx, tctx


@pytest.mark.parametrize("arch", ["editnet", "dcnet"])
@pytest.mark.parametrize("K", [1, 3, 5])
@pytest.mark.parametrize("length_penalty", [0.0, 0.7])
def test_backptr_identical_to_jax_and_register(arch, K, length_penalty):
    jm, jp, tm, tp = _setup(arch)
    jctx, tctx = _contexts(jm, jp, tm, tp)
    kw = dict(beam_size=K, start_id=START, end_id=END, max_len=MAX_LEN,
              length_penalty=length_penalty)
    j = jax_beam_search(jm, jp, jctx, impl="backptr", **kw)
    t = beam_search(tm, tp, tctx, impl="backptr", **kw)
    r = beam_search(tm, tp, tctx, impl="register", **kw)
    for f in ("tokens", "lengths", "all_tokens", "all_lengths"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    for f in ("scores", "all_scores"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), atol=1e-4,
                                   rtol=0, err_msg=f)
    for f in t._fields:
        assert torch.equal(getattr(t, f), getattr(r, f)), f
    # Hypotheses finished, at different steps for K > 1.
    finished = (t.all_tokens == END).any(dim=2)
    assert bool(finished.any())
    if K > 1:
        assert len(set(t.all_lengths[finished].tolist())) > 1


@pytest.mark.parametrize("arch", ["editnet", "dcnet"])
def test_backptr_live_beams_and_full_logits(arch):
    """end_id -1: nothing finishes, the live beams walk back from the last
    step; use_fused_head=False: the K*V candidate path."""
    for end_id, kw in ((-1, {}), (END, {"use_fused_head": False})):
        jm, jp, tm, tp = _setup(arch, **kw)
        jctx, tctx = _contexts(jm, jp, tm, tp)
        args = dict(beam_size=3, start_id=START, end_id=end_id,
                    max_len=MAX_LEN)
        j = jax_beam_search(jm, jp, jctx, impl="backptr", **args)
        t = beam_search(tm, tp, tctx, impl="backptr", **args)
        r = beam_search(tm, tp, tctx, impl="register", **args)
        np.testing.assert_array_equal(t.all_tokens.numpy(),
                                      np.asarray(j.all_tokens))
        np.testing.assert_allclose(t.all_scores.numpy(),
                                   np.asarray(j.all_scores), atol=1e-4,
                                   rtol=0)
        for f in t._fields:
            assert torch.equal(getattr(t, f), getattr(r, f)), f
        if end_id == -1:
            assert bool((t.all_lengths == MAX_LEN).all())


@pytest.mark.parametrize("return_path", [False, True])
def test_reconstruct_identical_to_jax(return_path):
    """Random histories and selections, inactive rows and finish steps
    before the last: tokens, and with ``return_path`` the slot chains."""
    rng = np.random.default_rng(5)
    L, B, K, J = 9, 4, 5, 3
    tok_hist = rng.integers(0, 50, (L, B, K)).astype(np.int32)
    par_hist = rng.integers(0, K, (L, B, K)).astype(np.int32)
    t_sel = rng.integers(0, L, (B, J)).astype(np.int32)
    slot_sel = rng.integers(0, K, (B, J)).astype(np.int32)
    active = rng.random((B, J)) > 0.25
    want = jax_reconstruct(jnp.asarray(tok_hist), jnp.asarray(par_hist),
                           jnp.asarray(t_sel), jnp.asarray(slot_sel),
                           jnp.asarray(active), 0, return_path=return_path)
    got = _reconstruct(torch.from_numpy(tok_hist), torch.from_numpy(par_hist),
                       torch.from_numpy(t_sel), torch.from_numpy(slot_sel),
                       torch.from_numpy(active), 0, return_path=return_path)
    if not return_path:
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool((got[0][~torch.from_numpy(active)] == 0).all())
