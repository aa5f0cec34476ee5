"""The port's training numerics (``captionkit_torch.nn.masking``,
``models/*.forward_seq``, ``models/editnet_backward.py``,
``models/dcnet_backward.py``, ``train/state.py``, ``train/xe.py``,
``train/checkpoint.py``) against the JAX reference on the CPU, on the same
weights (JAX init, carried over by the flat-name bridge) and the same numpy
inputs, at a small width.

Tolerances:
* ``masked_cross_entropy`` and ``top5_accuracy``: 1e-6 and ``==`` (the
  same fp32 log-softmax; a rank count on the same logits).
* ``forward_seq``: fp32 atol 1e-5; bf16 atol 1e-3 (the same operands
  rounded at the same places, fp32 sums in other orders; room for one
  bf16 rounding flip).
* Gradients against ``jax.grad`` of the JAX ``xe_loss`` (JAX's own
  deferred backward where the config takes it): per tensor, the largest
  difference over the largest magnitude, fp32 1e-5, bf16 1e-3; the
  attentions' query kernels and biases (``CANCELLING``) within four times
  the reference's own spread between its two backward routes where that
  is larger.
* The deferred backward against the port's own autograd through the loop
  at dropout 0.5 (the same masks from one generator): 1e-6 at fp32
  per tensor, and 2e-2 for the attention weights at their rounding
  floor (``AT_FLOOR``; a wrong mask or a dropped term moves every tensor
  by far more).
* Five train steps with clip and EMA against JAX's trajectory: params
  and EMA within 1e-5 at fp32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionkit.models import get_model as jax_get_model
from captionkit.nn.masking import masked_cross_entropy as j_mce
from captionkit.nn.masking import top5_accuracy as j_top5
from captionkit.train.checkpoint import load_params_npz as j_load_npz
from captionkit.train.state import create_train_state as j_create_state
from captionkit.train.state import ema_params as j_ema_params
from captionkit.train.xe import make_xe_train_step as j_make_step
from captionkit.train.xe import xe_loss as j_xe_loss
from captionkit.utils.config import ModelConfig as JaxModelConfig
from captionkit.utils.config import TrainConfig as JaxTrainConfig

from captionkit_torch.config import ModelConfig, TrainConfig
from captionkit_torch.models import editnet_backward
from captionkit_torch.models import get_model
from captionkit_torch.nn.masking import masked_cross_entropy, top5_accuracy
from captionkit_torch.params import (
    load_params_npz,
    named_tensors,
    params_from_tensors,
    save_params_npz,
)
from captionkit_torch.train.checkpoint import CheckpointManager
from captionkit_torch.train.state import (
    TrainState,
    create_train_state,
    ema_params,
    make_optimizer,
    trainable,
)
from captionkit_torch.train.xe import (
    BATCH_KEYS,
    make_eval_loss_step,
    make_xe_train_multistep,
    make_xe_train_step,
    xe_loss,
)

SMALL = dict(vocab_size=60, emb_dim=16, hidden_dim=24, att_dim=8,
             feat_dim=12, num_regions=5)
ATOL = {"float32": 1e-5, "bfloat16": 1e-3}
B, T_IN, T_OUT = 4, 7, 9


def _flat(jp) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    return {"/".join(str(getattr(k, "name", k)) for k in path):
            np.asarray(leaf) for path, leaf in flat if leaf is not None}


def _models(arch, dtype, **kw):
    over = dict(SMALL, arch=arch, compute_dtype=dtype, **kw)
    jm = jax_get_model(JaxModelConfig(**over))
    tm = get_model(ModelConfig(**over))
    jp = jm.init(jax.random.PRNGKey(1))
    arrays = _flat(jp)
    tp = trainable(params_from_tensors(
        {n: torch.from_numpy(a.copy()) for n, a in arrays.items()},
        _like(arch)))
    return jm, jp, tm, tp


def _like(arch):
    from captionkit_torch.models import dcnet, editnet

    cfg = ModelConfig(**dict(SMALL, arch=arch))
    mod = editnet if arch == "editnet" else dcnet
    return mod.init(0, cfg, "cpu")


def _batch(seed=0, valid_rows=B):
    rng = np.random.default_rng(seed)
    V = SMALL["vocab_size"]
    feats = rng.standard_normal((B, SMALL["num_regions"],
                                 SMALL["feat_dim"])).astype(np.float32)
    ex = rng.integers(4, V, (B, T_IN)).astype(np.int32)
    ex_len = np.asarray([T_IN, 2, 5, 3][:B], np.int32)
    tl = np.asarray([T_OUT, 3, 6, 2][:B], np.int32)
    tgt = rng.integers(4, V, (B, T_OUT)).astype(np.int32)
    tgt[:, 0] = 1
    for r in range(B):
        tgt[r, tl[r] - 1] = 2
        tgt[r, tl[r]:] = 0
    valid = np.arange(B) < valid_rows
    return dict(features=feats, existing=ex, existing_len=ex_len,
                target=tgt, target_len=tl, valid=valid)


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch_batch(b):
    out = {}
    for k, v in b.items():
        t = torch.from_numpy(np.asarray(v))
        out[k] = t.float() if k == "features" else (
            t.bool() if k == "valid" else t.long())
    return out


def _rel(j, t):
    j = np.asarray(j, np.float64)
    t = np.asarray(t, np.float64)
    scale = max(np.abs(j).max(), 1e-30)
    return np.abs(j - t).max() / scale


def _torch_grads(tm, tp, b, **kw):
    loss, metrics = xe_loss(tm, tp, *(_torch_batch(b)[k] for k in BATCH_KEYS),
                            **kw)
    named = named_tensors(tp)
    g = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return loss, metrics, {n: (torch.zeros_like(t) if x is None else x)
                           for (n, t), x in zip(named.items(), g)}


# ---------------------------------------------------------------- masking

@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_masked_cross_entropy_and_top5_match_jax(smoothing):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32) * 3
    logits[0, 0, :] = 1.0  # ties: rank counts only strictly larger
    targets = rng.integers(0, 11, (3, 5)).astype(np.int32)
    mask = rng.random((3, 5)) < 0.7
    j = j_mce(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask),
              label_smoothing=smoothing)
    t = masked_cross_entropy(torch.from_numpy(logits),
                             torch.from_numpy(targets).long(),
                             torch.from_numpy(mask),
                             label_smoothing=smoothing)
    np.testing.assert_allclose(float(t), float(j), atol=1e-6, rtol=0)
    ja = j_top5(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask))
    ta = top5_accuracy(torch.from_numpy(logits),
                       torch.from_numpy(targets).long(),
                       torch.from_numpy(mask))
    assert float(ta) == float(ja)
    empty = torch.zeros((3, 5), dtype=torch.bool)
    assert float(masked_cross_entropy(torch.from_numpy(logits),
                                      torch.from_numpy(targets).long(),
                                      empty)) == 0.0


# ---------------------------------------------------------- forward_seq

@pytest.mark.parametrize("arch,deferred", [
    ("editnet", True), ("editnet", False), ("dcnet", False),
    ("dcnet", True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [False, True])
def test_forward_seq_matches_jax(arch, deferred, dtype, train):
    key = ("deferred_backward" if arch == "editnet"
           else "dcnet_deferred_backward")
    jm, jp, tm, tp = _models(arch, dtype, dropout=0.0, **{key: deferred})
    b = _batch()
    jb, tb = _jax_batch(b), _torch_batch(b)
    jctx = jm.encode(jp, jb["features"], jb["existing"], jb["existing_len"])
    j = jm.forward_seq(jp, jctx, jm.init_state(jp, jctx),
                       jb["target"][:, :-1], jax.random.PRNGKey(0), train)
    with torch.no_grad():
        tctx = tm.encode(tp, tb["features"], tb["existing"],
                         tb["existing_len"])
        t = tm.forward_seq(tp, tctx, tm.init_state(tp, tctx),
                           tb["target"][:, :-1], train=train)
    assert tuple(t.shape) == tuple(j.shape) == (B, T_OUT - 1,
                                                SMALL["vocab_size"])
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("arch", ["editnet", "dcnet"])
def test_forward_seq_matches_a_loop_of_step(arch):
    """forward_seq against the port's own loop of ``step`` (the
    ``teacher_forcing_logits`` route of a model without forward_seq)."""
    from captionkit_torch.models.base import teacher_forcing_logits

    _, _, tm, tp = _models(arch, "float32", dropout=0.0)
    tb = _torch_batch(_batch())
    with torch.no_grad():
        ctx = tm.encode(tp, tb["features"], tb["existing"],
                        tb["existing_len"])
        a = tm.forward_seq(tp, ctx, tm.init_state(tp, ctx),
                           tb["target"][:, :-1])
        loop = dataclasses.replace(tm, forward_seq=None)
        b = teacher_forcing_logits(loop, tp, ctx, tm.init_state(tp, ctx),
                                   tb["target"][:, :-1])
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)


# ------------------------------------------------------------- gradients

#: The query kernel and bias of each attention: their gradient is the sum
#: over positions of the score cotangents times (1 - e²), and the score
#: cotangents of a softmax sum to zero, so the sum cancels to first order
#: and leaves a remainder near the rounding of its terms (1e-9 against
#: 1e-6 for the key kernel at this width).
CANCELLING = ("vis_attention/w_q", "vis_attention/b", "scma/w_q", "scma/b",
              "attention/w_q", "attention/b")


#: ``CANCELLING`` and the other weights of the attentions over the
#: caption (SCMA, DCNet's): their score cotangents are a softmax backward
#: over near-equal reads of the encoder states, so at this width their
#: gradients (1e-9 .. 1e-6, against 0.2 for the head's bias) sit at the
#: float32 rounding floor of the sums that form them; with dropout on,
#: the two routes' summation orders put them 1e-6 .. 5e-3 apart.
AT_FLOOR = CANCELLING + ("scma/w_enc", "scma/v", "attention/w_enc",
                         "attention/v")


def _jax_grads(arch, dtype, deferred, b):
    key = ("deferred_backward" if arch == "editnet"
           else "dcnet_deferred_backward")
    jm, jp, _, _ = _models(arch, dtype, dropout=0.0, **{key: deferred})
    jb = _jax_batch(b)

    def loss_fn(p):
        return j_xe_loss(jm, p, *(jb[k] for k in BATCH_KEYS),
                         rng=jax.random.PRNGKey(0), train=True)

    return jax.value_and_grad(loss_fn, has_aux=True)(jp)


@pytest.mark.parametrize("arch,deferred", [
    ("editnet", True), ("editnet", False), ("dcnet", True),
    ("dcnet", False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradients_match_jax_grad(arch, deferred, dtype):
    """Per tensor, max |port - JAX| / max |JAX| within 1e-5 (fp32) or 1e-3
    (bf16). The ``CANCELLING`` tensors are held instead within four times
    the reference's own spread between its two backward routes (deferred
    and autodiff) on the same inputs and dtype, where that is larger: the
    rounding floor of their cancelling sums."""
    key = ("deferred_backward" if arch == "editnet"
           else "dcnet_deferred_backward")
    _, _, tm, tp = _models(arch, dtype, dropout=0.0, **{key: deferred})
    b = _batch(valid_rows=3)  # a padding row of a tail batch
    (jl, jmet), jg = _jax_grads(arch, dtype, deferred, b)
    other = _flat(_jax_grads(arch, dtype, not deferred, b)[1])
    tl, tmet, tg = _torch_grads(tm, tp, b, train=True)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    assert int(tmet["tokens"]) == int(jmet["tokens"])
    assert float(tmet["top5_acc"]) == pytest.approx(float(jmet["top5_acc"]))
    jflat = _flat(jg)
    assert sorted(jflat) == sorted(tg)
    tol = 1e-5 if dtype == "float32" else 1e-3
    for n, g in tg.items():
        bound = tol
        if n in CANCELLING:
            bound = max(tol, 4 * _rel(jflat[n], other[n]))
        err = _rel(jflat[n], g.numpy())
        assert err <= bound, (n, err, bound)


@pytest.mark.parametrize("arch", ["editnet", "dcnet"])
def test_deferred_backward_matches_autograd_with_dropout(arch):
    key = ("deferred_backward" if arch == "editnet"
           else "dcnet_deferred_backward")
    b = _batch()
    out = {}
    for deferred in (True, False):
        _, _, tm, tp = _models(arch, "float32", dropout=0.5,
                               **{key: deferred})
        gen = torch.Generator().manual_seed(7)
        out[deferred] = _torch_grads(tm, tp, b, generator=gen, train=True)
    (la, _, ga), (lb, _, gb) = out[True], out[False]
    assert float(la.detach()) == pytest.approx(float(lb.detach()), rel=1e-6)
    for n in ga:
        err = _rel(gb[n].numpy(), ga[n].numpy())
        assert err <= (2e-2 if n in AT_FLOOR else 1e-6), (n, err)
    # The masks matter: a different generator gives a different loss.
    _, _, tm, tp = _models(arch, "float32", dropout=0.5, **{key: True})
    lc = _torch_grads(tm, tp, b, generator=torch.Generator().manual_seed(8),
                      train=True)[0]
    assert float(lc.detach()) != float(la.detach())


def test_hard_scma_falls_back_to_autograd(monkeypatch):
    """Hard SCMA never reaches the deferred Function (as the reference's
    ``forward_seq``), and its gradients match JAX's autodiff."""
    def boom(*a, **k):
        raise AssertionError("the deferred backward ran for hard SCMA")

    monkeypatch.setattr("captionkit_torch.models.editnet.recurrent_seq",
                        boom)
    jm, jp, tm, tp = _models("editnet", "float32", dropout=0.0,
                             scma_select="hard")
    b = _batch()
    jb = _jax_batch(b)
    jg = jax.grad(lambda p: j_xe_loss(jm, p, *(jb[k] for k in BATCH_KEYS),
                                      train=True)[0])(jp)
    _, _, tg = _torch_grads(tm, tp, b, train=True)
    jflat = _flat(jg)
    jother = _flat(_jax_grads("editnet", "float32", True, b)[1])
    for n, g in tg.items():
        bound = 1e-5
        if n in CANCELLING:
            bound = max(bound, 4 * _rel(jflat[n], jother[n]))
        assert _rel(jflat[n], g.numpy()) <= bound, n


def test_planted_fault_in_the_deferred_backward_shows(monkeypatch):
    _, _, tm, tp = _models("editnet", "float32", dropout=0.0)
    _, _, good = _torch_grads(tm, tp, _batch(), train=True)
    monkeypatch.setattr(editnet_backward, "PLANTED_FAULT", "lang_wrc")
    _, _, tm, tp = _models("editnet", "float32", dropout=0.0)
    _, _, bad = _torch_grads(tm, tp, _batch(), train=True)
    assert float(good["lang_lstm/wrc"].abs().max()) > 0
    assert float(bad["lang_lstm/wrc"].abs().max()) == 0
    assert _rel(good["lang_lstm/base/wx"].numpy(),
                bad["lang_lstm/base/wx"].numpy()) == 0


# ----------------------------------------------------- optimizer, steps

# The default learning rate; a clip that binds on the head's gradients.
TCFG = dict(learning_rate=4e-4, grad_clip=0.05, ema_decay=0.9,
            steps_per_dispatch=1)


def _jax_state(jm, tcfg):
    return j_create_state(lambda k: jm.init(jax.random.PRNGKey(1)), tcfg)


def _port_state(tm, jp, tcfg, arch):
    arrays = _flat(jp)
    params = params_from_tensors(
        {n: torch.from_numpy(a.copy()) for n, a in arrays.items()},
        _like(arch))
    return create_train_state(lambda seed: params, tcfg)


@pytest.mark.parametrize("arch,optimizer", [
    ("editnet", "adam"), ("editnet", "adamw"), ("editnet", "sgd"),
    ("dcnet", "adam")])
def test_five_train_steps_match_jax_trajectory(arch, optimizer):
    jm, jp, tm, _ = _models(arch, "float32", dropout=0.0)
    jcfg = JaxTrainConfig(optimizer=optimizer, **TCFG)
    tcfg = TrainConfig(optimizer=optimizer, **TCFG)
    js, ts = _jax_state(jm, jcfg), _port_state(tm, jp, tcfg, arch)
    jstep, tstep = j_make_step(jm, jcfg), make_xe_train_step(tm, tcfg)
    for i in range(5):
        b = _batch(seed=i)
        js, jmet = jstep(js, _jax_batch(b))
        ts, tmet = tstep(ts, _torch_batch(b))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-5)
    assert ts.step == int(js.step) == 5
    jflat, tflat = _flat(js.params), named_tensors(ts.params)
    for n, t in tflat.items():
        np.testing.assert_allclose(t.detach().numpy(), jflat[n], atol=1e-5,
                                   rtol=0, err_msg=n)
    jema, tema = _flat(j_ema_params(js)), named_tensors(ema_params(ts))
    for n, t in tema.items():
        np.testing.assert_allclose(t.numpy(), jema[n], atol=1e-5, rtol=0,
                                   err_msg=n)


def test_ema_starts_as_a_copy_and_validation_is_checked():
    _, _, tm, tp = _models("editnet", "float32")
    tcfg = TrainConfig(ema_decay=0.5)
    st = make_optimizer(tcfg).init(tp)
    for n, t in named_tensors(tp).items():
        assert st.ema[n].data_ptr() != t.data_ptr(), n
        assert torch.equal(st.ema[n], t.detach())
    for bad in (-0.1, 1.0, 1.5):
        with pytest.raises(ValueError, match="ema_decay"):
            make_optimizer(TrainConfig(ema_decay=bad))
    with pytest.raises(ValueError, match="optimizer"):
        make_optimizer(TrainConfig(optimizer="lamb"))
    assert make_optimizer(TrainConfig()).init(tp).ema is None


def _clone_state(ts: TrainState) -> TrainState:
    import copy

    named = {n: t.detach().clone().requires_grad_(True)
             for n, t in named_tensors(ts.params).items()}
    return TrainState(params=params_from_tensors(named, ts.params),
                      opt_state=copy.deepcopy(ts.opt_state), step=ts.step,
                      rng_seed=ts.rng_seed)


@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_multistep_equals_k_single_steps(dropout):
    _, jp, tm, _ = _models("editnet", "float32", dropout=dropout)
    tcfg = TrainConfig(**TCFG)
    s1 = _port_state(tm, jp, tcfg, "editnet")
    s2 = _clone_state(s1)
    step, multi = make_xe_train_step(tm, tcfg), make_xe_train_multistep(
        tm, tcfg)
    batches = [_torch_batch(_batch(seed=i)) for i in range(3)]
    losses = []
    for b in batches:
        s1, m = step(s1, b)
        losses.append(float(m["loss"]))
    s2, mm = multi(s2, {k: torch.stack([b[k] for b in batches])
                        for k in BATCH_KEYS})
    assert mm["loss"].shape == (3,)
    assert mm["loss"].tolist() == losses
    assert s1.step == s2.step == 3
    for (n, a), b in zip(named_tensors(s1.params).items(),
                         named_tensors(s2.params).values()):
        assert torch.equal(a, b), n


def test_eval_loss_step_matches_jax():
    from captionkit.train.xe import make_eval_loss_step as j_eval

    jm, jp, tm, tp = _models("editnet", "float32", dropout=0.5)
    b = _batch()
    jmet = j_eval(jm)(jp, _jax_batch(b))
    tmet = make_eval_loss_step(tm)(tp, _torch_batch(b))
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-6)
    assert int(tmet["tokens"]) == int(jmet["tokens"])


# ------------------------------------------------------------ checkpoints

def _trained(tm, jp, tcfg, steps):
    ts = _port_state(tm, jp, tcfg, "editnet")
    fn = make_xe_train_step(tm, tcfg)
    for i in range(steps):
        ts, _ = fn(ts, _torch_batch(_batch(seed=i)))
    return ts, fn


def test_checkpoint_round_trip_and_resume_bit_equal(tmp_path):
    _, jp, tm, _ = _models("editnet", "float32", dropout=0.5)
    tcfg = TrainConfig(**TCFG)
    ts, fn = _trained(tm, jp, tcfg, 2)
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    mgr.save(ts)
    assert mgr.latest_step() == 2
    restored = mgr.restore(_port_state(tm, jp, tcfg, "editnet"))
    assert restored.step == 2 and restored.rng_seed == ts.rng_seed
    assert restored.opt_state.count == ts.opt_state.count
    for (n, a), b in zip(named_tensors(ts.params).items(),
                         named_tensors(restored.params).values()):
        assert torch.equal(a, b) and b.requires_grad, n
    # Two more steps from the checkpoint equal two more uninterrupted.
    for i in (2, 3):
        ts, ma = fn(ts, _torch_batch(_batch(seed=i)))
        restored, mb = fn(restored, _torch_batch(_batch(seed=i)))
        assert float(ma["loss"]) == float(mb["loss"])
    for (n, a), b in zip(named_tensors(ts.params).items(),
                         named_tensors(restored.params).values()):
        assert torch.equal(a, b), n
    for n in ts.opt_state.ema:
        assert torch.equal(ts.opt_state.ema[n], restored.opt_state.ema[n])


def test_best_checkpoint_survives_rotation(tmp_path):
    _, jp, tm, _ = _models("editnet", "float32")
    tcfg = TrainConfig(**TCFG)
    ts = _port_state(tm, jp, tcfg, "editnet")
    fn = make_xe_train_step(tm, tcfg)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    metrics = [0.1, 0.5, 0.2, 0.3, 0.4]
    best_params = None
    for i, m in enumerate(metrics):
        ts, _ = fn(ts, _torch_batch(_batch(seed=i)))
        is_best = mgr.save(ts, metric=m)
        assert is_best == (m == max(metrics[:i + 1]))
        if is_best:
            best_params = {n: t.detach().clone()
                           for n, t in named_tensors(ts.params).items()}
    assert mgr.all_steps() == [4, 5]  # rotation kept the last two
    assert mgr.best_metric() == 0.5 and mgr.best_step() == 2
    best = mgr.restore_best(_port_state(tm, jp, tcfg, "editnet"))
    assert best.step == 2
    for n, t in named_tensors(best.params).items():
        assert torch.equal(t, best_params[n]), n
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(ts)


def test_port_trained_npz_loads_in_jax_and_back(tmp_path):
    jm, jp, tm, _ = _models("editnet", "float32", dropout=0.0)
    ts, _ = _trained(tm, jp, TrainConfig(**TCFG), 2)
    path = str(tmp_path / "p.npz")
    save_params_npz(ts.params, path)
    back = _flat(j_load_npz(jp, path))
    for n, t in named_tensors(ts.params).items():
        np.testing.assert_array_equal(back[n], t.detach().numpy(), n)
    tp = load_params_npz(path, "cpu")
    for n, t in named_tensors(tp).items():
        assert torch.equal(t, named_tensors(ts.params)[n].detach()), n
