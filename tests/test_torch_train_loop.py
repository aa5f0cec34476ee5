"""The port's XE training loop (``captionkit_torch.train.loop``), its
preemption guard, its run log and ``cli train-xe`` against the JAX
reference on the CPU, on a tiny synthetic split (the same data on both
sides: both packages' ``SyntheticCaptionSource`` draw the same split from
one seed) and the same initial weights (bridged), at fp32 and dropout 0.

Tolerances: the per-epoch loss and top-5 accuracy within 1e-5 relative
(fp32 sums in other orders over a few steps); validation CIDEr-D within
1e-9 (the decoded captions are identical); a resumed or preempted run
bit-equal to the uninterrupted one (the same arithmetic on one device).
"""

import contextlib
import dataclasses
import io
import json
import signal
import threading

import jax
import numpy as np
import pytest
import torch

import captionkit.cli as jax_cli
import captionkit.train.loop as jloop
from captionkit.data import SyntheticCaptionSource as JSource
from captionkit.models import get_model as jax_get_model
from captionkit.train.state import create_train_state as j_create_state
from captionkit.utils.config import CaptionKitConfig as JaxConfig

import captionkit_torch.train.loop as tloop
from captionkit_torch import cli
from captionkit_torch.config import CaptionKitConfig
from captionkit_torch.data import SyntheticCaptionSource
from captionkit_torch.models import get_model
from captionkit_torch.params import named_tensors, params_from_tensors
from captionkit_torch.train.checkpoint import CheckpointManager
from captionkit_torch.train.state import create_train_state
from captionkit_torch.utils.logging import MetricsLogger
from captionkit_torch.utils.preemption import PreemptionGuard

R, F = 4, 12
SMALL = dict(emb_dim=16, hidden_dim=24, att_dim=8, feat_dim=F,
             num_regions=R, dropout=0.0, compute_dtype="float32",
             head_impl="xla")
OVER = {
    **{f"model.{k}": v for k, v in SMALL.items()},
    "data.batch_size": 8, "data.max_len": 12,
    "decode.beam_size": 3, "decode.batch_size": 8,
    "decode.max_decode_len": 10,
    "train.epochs": 2, "train.log_every": 1, "train.steps_per_dispatch": 1,
    "train.grad_clip": 0.1, "train.ema_decay": 0.5,
}
SRC = dict(num_images=10, captions_per_image=2, num_regions=R, feat_dim=F,
           max_len=12, seed=3)


def _flat(jp):
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    return {"/".join(str(getattr(k, "name", k)) for k in path):
            np.asarray(leaf) for path, leaf in flat if leaf is not None}


def _setup(**over):
    over = {**OVER, **over}
    jsrc, tsrc = JSource(**SRC), SyntheticCaptionSource(**SRC)
    v = len(tsrc.vocab)
    jcfg = JaxConfig().override({**over, "model.vocab_size": v})
    tcfg = CaptionKitConfig().override({**over, "model.vocab_size": v})
    jm, tm = jax_get_model(jcfg.model), get_model(tcfg.model)
    jp = jm.init(jax.random.PRNGKey(2))
    like = tm.init(0, "cpu")

    def t_init(seed):
        return params_from_tensors(
            {n: torch.from_numpy(a.copy()) for n, a in _flat(jp).items()},
            like)

    jstate = j_create_state(lambda k: jp, jcfg.train)
    tstate = create_train_state(t_init, tcfg.train)
    return (jsrc, jcfg, jm, jstate), (tsrc, tcfg, tm, tstate)


@pytest.mark.parametrize("k", [1, 2])
def test_run_xe_training_matches_jax(k):
    """k = 1 (the issue's protocol) and k = 2 (JAX's scanned k-step
    program against the port's k-step call; no lr decay in two epochs)."""
    (jsrc, jcfg, jm, js), (tsrc, tcfg, tm, ts) = _setup(
        **{"train.steps_per_dispatch": k})
    js, jrep = jloop.run_xe_training(jm, js, jcfg, jsrc.dataset,
                                     jsrc.eval_view())
    ts, trep = tloop.run_xe_training(tm, ts, tcfg, tsrc.dataset,
                                     tsrc.eval_view(), device="cpu")
    assert trep.epochs_run == jrep.epochs_run == 2
    assert ts.step == int(js.step) == 6  # 20 rows, 3 batches an epoch
    for j, t in zip(jrep.history, trep.history):
        assert t["epoch"] == j["epoch"]
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
        np.testing.assert_allclose(t["top5_acc"], j["top5_acc"], rtol=1e-5)
        np.testing.assert_allclose(t["val_cider"], j["val_cider"],
                                   atol=1e-9, rtol=0)
        assert t["val_decode_s"] > 0 and t["val_score_s"] >= 0
    assert trep.best_metric == pytest.approx(jrep.best_metric, abs=1e-9)
    assert trep.best_epoch == jrep.best_epoch
    jflat = _flat(js.params)
    for n, t in named_tensors(ts.params).items():
        np.testing.assert_allclose(t.detach().numpy(), jflat[n], atol=1e-5,
                                   rtol=0, err_msg=n)


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def wrapped(*a, **k):
        cfg = a[1]
        calls.append(k.get("learning_rate") or cfg.learning_rate)
        return real(*a, **k)

    monkeypatch.setattr(module, name, wrapped)


def test_lr_decay_reaches_the_packed_steps(monkeypatch):
    """Known difference by design: on a validation plateau the reference
    rebuilds only its single step with the decayed lr and its k-step
    program keeps the first lr; the port rebuilds both."""
    over = {"train.steps_per_dispatch": 2, "train.epochs": 3,
            "train.lr_decay_patience": 1, "train.lr_decay_factor": 0.5,
            "train.early_stop_patience": 10, "train.ema_decay": 0.0}
    (jsrc, jcfg, jm, js), (tsrc, tcfg, tm, ts) = _setup(**over)
    monkeypatch.setattr(jloop, "_validate", lambda *a, **k: 0.25)
    monkeypatch.setattr(tloop, "_validate", lambda *a, **k: {
        "CIDEr": 0.25, "wall_s": 0.0, "score_s": 0.0})
    jcalls, tcalls = {"s": [], "m": []}, {"s": [], "m": []}
    _spy(monkeypatch, jloop, "make_xe_train_step", jcalls["s"])
    _spy(monkeypatch, jloop, "make_xe_train_multistep", jcalls["m"])
    _spy(monkeypatch, tloop, "make_xe_train_step", tcalls["s"])
    _spy(monkeypatch, tloop, "make_xe_train_multistep", tcalls["m"])
    jloop.run_xe_training(jm, js, jcfg, jsrc.dataset, jsrc.eval_view())
    _, rep = tloop.run_xe_training(tm, ts, tcfg, tsrc.dataset,
                                   tsrc.eval_view(), device="cpu")
    lr = tcfg.train.learning_rate
    # Plateau after epochs 1 and 2 (epoch 0 sets the best): two decays.
    assert tcalls["s"] == tcalls["m"] == [lr, lr * 0.5, lr * 0.25]
    assert jcalls["s"] == [lr, lr * 0.5, lr * 0.25]
    assert jcalls["m"] == [lr]  # the reference's packed steps keep lr
    assert rep.epochs_run == 3


def test_lr_decay_changes_the_packed_trajectory(monkeypatch):
    """The decayed lr is the one the k-step calls apply: three epochs with
    a decay after the second equal two epochs, then the third epoch's
    packs stepped by hand at the decayed lr."""
    from captionkit_torch.train.xe import (
        batch_to_device_dict,
        make_xe_train_multistep,
        make_xe_train_step,
    )

    over = {"train.steps_per_dispatch": 2, "train.epochs": 3,
            "train.lr_decay_patience": 1, "train.lr_decay_factor": 0.5,
            "train.ema_decay": 0.0}
    runs = {}
    for epochs in (3, 2):
        _, (tsrc, tcfg, tm, ts) = _setup(**{**over, "train.epochs": epochs})
        cider = iter([0.5, 0.25, 0.1])
        monkeypatch.setattr(tloop, "_validate", lambda *a, **k: {
            "CIDEr": next(cider), "wall_s": 0.0, "score_s": 0.0})
        runs[epochs], _ = tloop.run_xe_training(
            tm, ts, tcfg, tsrc.dataset, tsrc.eval_view(), device="cpu")
    tc = tcfg.train
    half = tc.learning_rate * 0.5
    fns = {"multi": make_xe_train_multistep(tm, tc, learning_rate=half),
           "single": make_xe_train_step(tm, tc, learning_rate=half)}
    st = runs[2]
    kinds = []
    for kind, hb in tloop._pack_host_batches(
            (tloop._host_dict(b) for b in tsrc.dataset.batches(
                8, shuffle=True, seed=tc.seed + 2)), 2):
        st, _ = fns[kind](st, batch_to_device_dict(hb, "cpu"))
        kinds.append(kind)
    assert "multi" in kinds
    assert st.step == runs[3].step
    _params_equal(runs[3], st)


def _params_equal(a, b):
    for (n, x), y in zip(named_tensors(a.params).items(),
                         named_tensors(b.params).values()):
        assert torch.equal(x, y), n


def test_resume_continues_the_data_order(tmp_path):
    """5 steps, checkpoint, resume for 4 more: bit-equal to 9 steps in one
    run (the epoch has 3 steps, so the resume starts mid-epoch)."""
    over = {"train.epochs": 4, "model.dropout": 0.5}
    _, (tsrc, tcfg, tm, ts) = _setup(**over)
    full, rep = tloop.run_xe_training(tm, ts, tcfg, tsrc.dataset, None,
                                      max_steps=9, device="cpu")
    assert full.step == 9
    _, (tsrc, tcfg, tm, ts) = _setup(**over)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    part, _ = tloop.run_xe_training(tm, ts, tcfg, tsrc.dataset, None,
                                    ckpt=mgr, max_steps=5, device="cpu")
    assert mgr.latest_step() == 5
    _, (tsrc, tcfg, tm, fresh) = _setup(**over)
    resumed = mgr.restore(fresh)
    resumed, rep2 = tloop.run_xe_training(tm, resumed, tcfg, tsrc.dataset,
                                          None, max_steps=4, device="cpu")
    assert resumed.step == 9
    _params_equal(full, resumed)
    assert [h["epoch"] for h in rep2.history] == [1, 2]


def test_preemption_checkpoints_at_the_exact_step_and_resumes(tmp_path):
    over = {"train.epochs": 50}
    _, (tsrc, tcfg, tm, ts) = _setup(**over)
    guard = PreemptionGuard(signals=())
    calls = {"n": 0}
    real = tloop.make_xe_train_step

    def counting(*a, **k):
        fn = real(*a, **k)

        def step(state, batch):
            calls["n"] += 1
            if calls["n"] == 4:
                guard.request()
            return fn(state, batch)
        return step

    tloop.make_xe_train_step = counting
    try:
        mgr = CheckpointManager(str(tmp_path / "pre"), keep=2)
        st, rep = tloop.run_xe_training(tm, ts, tcfg, tsrc.dataset, None,
                                        ckpt=mgr, preemption=guard,
                                        device="cpu")
    finally:
        tloop.make_xe_train_step = real
    assert rep.preempted and rep.history[-1]["preempted"]
    assert st.step == 4 and mgr.latest_step() == 4
    _, (_, _, _, fresh) = _setup(**over)
    _params_equal(st, mgr.restore(fresh))
    # A guard already set: no step runs.
    guard2 = PreemptionGuard(signals=())
    guard2.request()
    _, (tsrc, tcfg, tm, ts) = _setup(**over)
    st2, rep2 = tloop.run_xe_training(tm, ts, tcfg, tsrc.dataset, None,
                                      preemption=guard2, device="cpu")
    assert st2.step == 0 and rep2.preempted


def test_preemption_guard_latches_a_signal_and_restores_the_handler():
    prev = signal.getsignal(signal.SIGUSR1)
    with PreemptionGuard(signals=(signal.SIGUSR1,)) as guard:
        assert not guard.requested
        signal.raise_signal(signal.SIGUSR1)
        assert guard.requested
    assert signal.getsignal(signal.SIGUSR1) == prev
    g = PreemptionGuard(signals=())
    t = threading.Thread(target=g.request)
    t.start()
    t.join()
    assert g.requested


def test_metrics_logger_writes_jsonl(tmp_path):
    lg = MetricsLogger(str(tmp_path / "run"))
    lg.log(3, {"train/loss": 1.5}, wall=10.0)
    lg.log(4, {"val/cider": np.float32(0.25)})
    lg.close()
    rows = [json.loads(x) for x in
            (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert rows[0] == {"step": 3, "time": 10.0, "train/loss": 1.5}
    assert rows[1]["step"] == 4 and rows[1]["val/cider"] == 0.25


def _sets(over):
    return [a for k, v in over.items() for a in ("--set", f"{k}={v}")]


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return json.loads(out.getvalue())


def test_cli_train_xe_exports_weights_jax_decodes_alike(tmp_path):
    over = {**OVER, "train.checkpoint_dir": str(tmp_path / "ck"),
            "train.ema_decay": 0.5}
    npz, ema = str(tmp_path / "p.npz"), str(tmp_path / "ema.npz")
    rep = _run(cli.main, ["train-xe", "--config", "xe_train", "--synthetic",
                          "--images", "10", "--max-steps", "3",
                          "--export-params", npz, "--export-ema", ema,
                          "--run-dir", str(tmp_path / "run"),
                          "--device", "cpu", *_sets(over)])
    assert rep["step"] == 3 and rep["best_val_cider"] is not None
    assert (tmp_path / "run" / "metrics.jsonl").exists()
    rep2 = _run(cli.main, ["train-xe", "--config", "xe_train",
                           "--synthetic", "--images", "10", "--max-steps",
                           "2", "--resume", "--no-val", "--device", "cpu",
                           *_sets(over)])
    assert rep2["step"] == 5 and rep2["best_val_cider"] is None
    dec = {k: v for k, v in over.items() if k.startswith(("model.",
                                                          "decode."))}
    outs = {}
    for who, main, pre, post in (
            ("j", jax_cli.main, ["--platform", "cpu"], []),
            ("t", cli.main, [], ["--device", "cpu"])):
        path = tmp_path / f"{who}.json"
        _run(main, pre + ["decode", "--config", "editnet_beam5",
                          "--synthetic", "--images", "10", "--params", npz,
                          "--out", str(path), *_sets(dec)] + post)
        outs[who] = path.read_bytes()
    assert outs["t"] == outs["j"]
    # A rank outside --num-shards is refused before any rendezvous.
    with pytest.raises(SystemExit, match="W = 2"):
        cli.main(["train-xe", "--config", "xe_train", "--synthetic",
                  "--num-shards", "2", "--shard-index", "2",
                  "--device", "cpu"])
    with pytest.raises(SystemExit, match="ema_decay"):
        _run(cli.main, ["train-xe", "--config", "xe_train", "--synthetic",
                        "--images", "10", "--max-steps", "1", "--no-val",
                        "--export-ema", ema, "--device", "cpu",
                        *_sets({**over, "train.ema_decay": 0.0,
                                "train.checkpoint_dir":
                                str(tmp_path / "ck2")})])


def test_train_xe_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["train-xe", "--config", "xe_train", "--synthetic",
                  *_sets({"train.checkpoint_dir": str(tmp_path)})])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tloop.run_xe_training(None, None, CaptionKitConfig(), None)
