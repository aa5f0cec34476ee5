"""The port's SCST loop (``captionkit_torch.train.loop.run_scst_training``)
and ``cli train-scst`` against the JAX reference on the CPU, on a tiny
synthetic split (both packages' ``SyntheticCaptionSource`` draw the same
split from one seed) and the same initial weights (bridged), fp32,
dropout 0.

The two packages draw their samples from different generators, so the
loop comparison replaces the sample leg on both sides, in the test, by
the same fixed token table per image (a function of the image's
features), through the loop modules' ``make_scst_rollout``; the greedy
leg, the rewards, the updates and the validation are the packages' own.

Tolerances: per-epoch mean advantage within 1e-5 relative, validation
CIDEr-D within 1e-9 (identical captions), parameters within 1e-5 (fp32
sums in other orders over a few Adam steps); the pipelined schedule, the
step budget and a preempted run's checkpoint bit-equal to what they
reproduce (the same arithmetic on one device).
"""

import contextlib
import dataclasses
import hashlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import captionkit.cli as jax_cli
import captionkit.train.loop as jloop
from captionkit.data import SyntheticCaptionSource as JSource
from captionkit.models import get_model as jax_get_model
from captionkit.train.checkpoint import save_params_npz as jax_save_npz
from captionkit.train.state import create_train_state as j_create_state
from captionkit.utils.config import CaptionKitConfig as JaxConfig

import captionkit_torch.train.loop as tloop
from captionkit_torch import cli
from captionkit_torch.config import CaptionKitConfig
from captionkit_torch.data import SyntheticCaptionSource
from captionkit_torch.metrics.cider import NgramDocFreq
from captionkit_torch.models import get_model
from captionkit_torch.params import named_tensors, params_from_tensors
from captionkit_torch.train import scst
from captionkit_torch.train.checkpoint import CheckpointManager
from captionkit_torch.train.state import create_train_state
from captionkit_torch.train.xe import batch_to_device_dict

R, F, L = 4, 12, 10
SMALL = dict(emb_dim=16, hidden_dim=24, att_dim=8, feat_dim=F,
             num_regions=R, dropout=0.0, compute_dtype="float32")
OVER = {
    **{f"model.{k}": v for k, v in SMALL.items()},
    "data.batch_size": 8, "data.max_len": 12,
    "decode.beam_size": 3, "decode.batch_size": 8,
    "decode.max_decode_len": L,
    "train.scst_epochs": 2, "train.log_every": 1,
    "train.grad_clip": 0.1, "train.ema_decay": 0.5,
    "train.scst_learning_rate": 1e-2,
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
    jcfg = JaxConfig().override({**over, "model.vocab_size": v,
                                 "train.donate_state": False})
    tcfg = CaptionKitConfig().override({**over, "model.vocab_size": v})
    jm, tm = jax_get_model(jcfg.model), get_model(tcfg.model)
    jp = jm.init(jax.random.PRNGKey(2))
    like = tm.init(0, "cpu")

    def t_init(seed):
        return params_from_tensors(
            {n: torch.from_numpy(a.copy()) for n, a in _flat(jp).items()},
            like)

    return ((jsrc, jcfg, jm, j_create_state(lambda k: jp, jcfg.train)),
            (tsrc, tcfg, tm, create_train_state(t_init, tcfg.train)))


def _table(features: np.ndarray, vocab_size: int, end: int, pad: int):
    """The fixed sample of each image: (tokens [B, L] int32, mask), a
    function of its feature row (padding rows of zeros get an immediate
    end)."""
    toks = np.full((len(features), L), pad, np.int32)
    mask = np.zeros((len(features), L), bool)
    for i, row in enumerate(np.asarray(features, np.float32)):
        if not row.any():
            toks[i, 0], mask[i, 0] = end, True
            continue
        seed = int.from_bytes(hashlib.sha256(row.tobytes()).digest()[:8],
                              "little")
        rng = np.random.default_rng(seed)
        n = int(rng.integers(2, L))
        toks[i, :n] = rng.integers(4, vocab_size, n)
        toks[i, n] = end
        mask[i, :n + 1] = True
    return toks, mask


def _fixed_samples(monkeypatch, vocab_size):
    """Both loops' sample legs read the fixed table."""
    j_real, t_real = jloop.make_scst_rollout, tloop.make_scst_rollout

    def j_make(model, **kw):
        fn = j_real(model, **kw)

        def roll(params, batch, rng):
            out = dict(fn(params, batch, rng))
            toks, mask = _table(np.asarray(batch["features"]),
                                vocab_size, kw["end_id"], kw["pad_id"])
            out["sample_tokens"], out["sample_mask"] = (jnp.asarray(toks),
                                                        jnp.asarray(mask))
            return out
        return roll

    def t_make(model, **kw):
        fn = t_real(model, **kw)

        def roll(params, batch, generator):
            out = fn(params, batch, generator)
            toks, mask = _table(batch["features"].numpy(), vocab_size,
                                kw["end_id"], kw["pad_id"])
            out["sample_tokens"] = torch.from_numpy(toks)
            out["sample_mask"] = torch.from_numpy(mask)
            out["host"] = dict(out["host"],
                               sample_tokens=out["sample_tokens"])
            return out
        return roll

    monkeypatch.setattr(jloop, "make_scst_rollout", j_make)
    monkeypatch.setattr(tloop, "make_scst_rollout", t_make)


def test_run_scst_training_matches_jax(monkeypatch):
    (jsrc, jcfg, jm, js), (tsrc, tcfg, tm, ts) = _setup()
    _fixed_samples(monkeypatch, len(tsrc.vocab))
    js, jrep = jloop.run_scst_training(jm, js, jcfg, jsrc.dataset,
                                       jsrc.eval_view())
    ts, trep = tloop.run_scst_training(tm, ts, tcfg, tsrc.dataset,
                                       tsrc.eval_view(), device="cpu")
    assert trep.epochs_run == jrep.epochs_run == 2
    assert ts.step == int(js.step) == 6  # 20 rows, 3 batches an epoch
    for j, t in zip(jrep.history, trep.history):
        assert t["epoch"] == j["epoch"]
        np.testing.assert_allclose(t["mean_advantage"], j["mean_advantage"],
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(t["val_cider"], j["val_cider"],
                                   atol=1e-9, rtol=0)
    assert trep.best_epoch == jrep.best_epoch
    assert any(t["mean_advantage"] != 0 for t in trep.history)
    jflat = _flat(js.params)
    for n, t in named_tensors(ts.params).items():
        np.testing.assert_allclose(t.detach().numpy(), jflat[n], atol=1e-5,
                                   rtol=0, err_msg=n)


def _seed(*words):
    return int(np.random.SeedSequence(list(words)).generate_state(
        1, np.uint64)[0])


def _snapshot(state):
    return {n: t.detach().clone() for n, t in named_tensors(
        state.params).items()}


def test_pipelined_rollout_reads_the_params_before_the_previous_update(
        monkeypatch):
    """One pipelined epoch against a hand-run schedule: rollout k+1 gets a
    snapshot of the parameters taken before update k and its generator
    from (rng_seed, epoch, k+1); the final parameters are bit-equal, and
    the loop's rollout k+1 saw exactly the parameters from before update
    k."""
    _, (tsrc, tcfg, tm, ts) = _setup(**{"train.scst_epochs": 1})
    seen = []
    real = tloop.make_scst_rollout

    def spy(model, **kw):
        fn = real(model, **kw)

        def roll(params, batch, generator):
            seen.append({n: t.detach().clone()
                         for n, t in named_tensors(params).items()})
            return fn(params, batch, generator)
        return roll

    monkeypatch.setattr(tloop, "make_scst_rollout", spy)
    state0 = _snapshot(ts)
    got, _ = tloop.run_scst_training(tm, ts, tcfg, tsrc.dataset, None,
                                     pipeline=True, device="cpu")
    assert got.step == 3 and len(seen) == 3

    _, (_, _, _, st) = _setup(**{"train.scst_epochs": 1})
    v, tc = tsrc.vocab, tcfg.train
    rollout_fn = real(tm, start_id=v.start, end_id=v.end, pad_id=v.pad,
                      max_len=L)
    update_fn = scst.make_scst_update(
        tm, dataclasses.replace(tc, learning_rate=tc.scst_learning_rate),
        start_id=v.start)
    rewarder = scst.ScstRewarder(
        v, NgramDocFreq.build(tsrc.dataset.references))
    before_update, pending = [], None
    for k, hb in enumerate(tsrc.dataset.batches(8, shuffle=True,
                                                seed=tc.seed + 1000)):
        snap = _snapshot(st)
        before_update.append(snap)
        gen = torch.Generator().manual_seed(_seed(st.rng_seed, 0, k))
        roll = rollout_fn(params_from_tensors(snap, st.params),
                          batch_to_device_dict(hb, "cpu"), gen)
        item = (batch_to_device_dict(hb, "cpu"),
                rewarder.intern([tsrc.dataset.references[int(i)]
                                 for i in hb.image_id]),
                roll)
        if pending is not None:
            st, _ = tloop._apply_pending(st, pending, update_fn, rewarder)
        pending = item
    st, _ = tloop._apply_pending(st, pending, update_fn, rewarder)
    final = _snapshot(st)
    for n, t in named_tensors(got.params).items():
        assert torch.equal(t.detach(), final[n]), n
    # Rollout k+1 of the loop ran on the parameters from before update k:
    # rollouts 0 and 1 on the initial ones, rollout 2 on those after one
    # update.
    for k, want in enumerate([state0, state0, before_update[2]]):
        assert all(torch.equal(seen[k][n], want[n]) for n in want), k
    assert not all(torch.equal(seen[2][n], state0[n]) for n in state0)


@pytest.mark.parametrize("pipeline", [False, True])
def test_max_steps_and_preemption_checkpoint_exactly(pipeline, tmp_path,
                                                     monkeypatch):
    """``max_steps=2`` stops after two updates in both modes. A run whose
    guard fires at a step boundary (serial: after two updates; pipelined:
    after one, so the second rollout is in flight and dropped) returns and
    checkpoints exactly the state of the run with that many steps."""
    _, (tsrc, tcfg, tm, ts) = _setup()
    two, rep = tloop.run_scst_training(tm, ts, tcfg, tsrc.dataset, None,
                                       max_steps=2, pipeline=pipeline,
                                       device="cpu")
    assert two.step == 2 and rep.epochs_run == 1 and not rep.preempted
    n = 1 if pipeline else 2
    _, (_, _, _, ts1) = _setup()
    short, _ = tloop.run_scst_training(tm, ts1, tcfg, tsrc.dataset, None,
                                       max_steps=n, pipeline=pipeline,
                                       device="cpu")
    assert short.step == n

    updates = []
    real = tloop.make_scst_update

    def counting(*a, **k):
        fn = real(*a, **k)

        def step(*args):
            updates.append(1)
            return fn(*args)
        return step

    class Guard:
        @property
        def requested(self):
            return len(updates) >= n

    monkeypatch.setattr(tloop, "make_scst_update", counting)
    _, (_, _, _, ts2) = _setup()
    ckpt = CheckpointManager(str(tmp_path / "ck"), keep=2)
    got, rep = tloop.run_scst_training(tm, ts2, tcfg, tsrc.dataset, None,
                                       ckpt=ckpt, pipeline=pipeline,
                                       preemption=Guard(), device="cpu")
    assert rep.preempted and got.step == n and len(updates) == n
    assert rep.history[-1]["preempted"]
    _, (_, _, _, fresh) = _setup()
    restored = ckpt.restore(fresh)
    ckpt.close()
    assert restored.step == n
    want = _snapshot(short)
    for name, t in named_tensors(got.params).items():
        assert torch.equal(t.detach(), want[name]), name
        assert torch.equal(named_tensors(restored.params)[name].detach(),
                           want[name]), name


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return json.loads(out.getvalue())


def test_cli_train_scst_exports_what_jax_decodes_alike(tmp_path):
    """``cli train-scst --device cpu --params xe.npz`` for two steps with
    validation; JAX's ``cli decode`` and the port's decode the exported
    ``.npz`` to byte-identical results files. A comma list, shards and a
    ``--val-split`` without ``--prepared`` are refused."""
    sets = [a for k, v in OVER.items() if k.startswith(("model.",
                                                        "decode."))
            for a in ("--set", f"{k}={v}")]
    src = SyntheticCaptionSource(num_images=6, captions_per_image=5,
                                 num_regions=R, feat_dim=F, max_len=22,
                                 seed=0)
    jm = jax_get_model(JaxConfig().override(
        {**{f"model.{k}": v for k, v in SMALL.items()},
         "model.vocab_size": len(src.vocab)}).model)
    xe = str(tmp_path / "xe.npz")
    jax_save_npz(jm.init(jax.random.PRNGKey(3)), xe)
    common = ["--config", "scst_train", "--synthetic", "--images", "6",
              *sets, "--device", "cpu"]
    report = _run(cli.main, [
        "train-scst", *common, "--params", xe, "--max-steps", "2",
        "--set", "data.batch_size=4", "--set", "train.log_every=1",
        "--set", f"train.checkpoint_dir={tmp_path / 'ck'}",
        "--export-params", str(tmp_path / "scst.npz"),
        "--run-dir", str(tmp_path / "run")])
    assert report["step"] == 2 and report["best_val_cider"] is not None
    rows = [json.loads(x) for x in
            (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert any("scst/mean_advantage" in r for r in rows)
    files = {}
    for who, main, extra in (("j", jax_cli.main, ["--platform", "cpu"]),
                             ("t", cli.main, [])):
        path = tmp_path / f"{who}.json"
        argv = ["decode", "--config", "editnet_beam5", "--synthetic",
                "--images", "6", *sets, "--params",
                str(tmp_path / "scst.npz"), "--no-metrics", "--out",
                str(path)]
        _run(main, extra + argv + (["--device", "cpu"] if who == "t"
                                   else []))
        files[who] = path.read_bytes()
    assert files["t"] == files["j"]
    for bad, msg in ((["--params", f"{xe},{xe}"], "one --params"),
                     (["--num-shards", "2", "--shard-index", "2"],
                      "W = 2"),
                     (["--val-split", "val"], "--val-split needs")):
        with pytest.raises(SystemExit, match=msg):
            cli.main(["train-scst", *common, *bad])
