"""The host's epoch drivers for cross-entropy and SCST training
(``captionkit.train.loop``).

Both loops take their batches through ``data/prefetch.py::
prefetch_to_device``: on the card, two batches ahead, staged in pinned
memory and copied on a side stream while the current step runs.

``run_xe_training`` iterates epochs of shuffled batches, runs the train
step (``train/xe.py``; k steps a call with ``steps_per_dispatch`` > 1),
validates every ``eval_every_epochs`` by decoding the validation split
with the configured beam search and scoring CIDEr-D (on the EMA weights
when EMA is on), keeps the best checkpoint by it, decays the learning
rate on a plateau and stops early, as the reference does. Step metrics
stay on the card until a log boundary: no per-step ``.item()``.

``run_scst_training`` is the self-critical phase (``train/scst.py``):
serial (rollout, host reward, update, batch after batch) or pipelined
(batch k+1's rollout is enqueued before batch k's reward and update, so it
reads the parameters from before update k: one step of policy staleness,
as in the reference). Each epoch validates (EMA weights when EMA is on)
and keeps the best checkpoint by CIDEr.

Two differences from the reference in the XE loop, both by design:

* lr decay reaches every step. The reference rebuilds only its single
  step with the decayed rate, so the k-step programs it runs with the
  default ``steps_per_dispatch=8`` keep the first rate. Here the single
  and the k-step functions are both rebuilt.
* A resumed state continues the data order. The loop starts at epoch
  ``step // steps_per_epoch`` and skips the batches that state already
  took, so a resumed run takes the batches the uninterrupted run would
  have. The reference starts every call at epoch 0's first batch.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from captionkit_torch.config import CaptionKitConfig
from captionkit_torch.data.prefetch import prefetch_to_device
from captionkit_torch.data.sources import CaptionDataset
from captionkit_torch.decode.driver import evaluate_split, make_decode_fn
from captionkit_torch.device import resolve_device
from captionkit_torch.metrics.eval import CaptionEvaluator
from captionkit_torch.models.base import ModelDef
from captionkit_torch.params import named_tensors, params_from_tensors
from captionkit_torch.train.checkpoint import CheckpointManager
from captionkit_torch.metrics.cider import NgramDocFreq
from captionkit_torch.train.scst import (
    ScstRewarder,
    apply_rollout,
    make_scst_rollout,
    make_scst_update,
    scst_train_step,
)
from captionkit_torch.train.state import TrainState, ema_params
from captionkit_torch.train.xe import (
    BATCH_KEYS,
    batch_host_tensors,
    make_xe_train_multistep,
    make_xe_train_step,
)
from captionkit_torch.utils.logging import MetricsLogger

log = logging.getLogger("captionkit_torch.train")


def _host_dict(batch) -> dict:
    return {k: getattr(batch, k) for k in BATCH_KEYS}


class AverageMeter:
    """Running average of logged values."""

    def __init__(self) -> None:
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1) -> None:
        self.sum += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0


@dataclass
class TrainReport:
    epochs_run: int = 0
    best_metric: float = float("-inf")
    best_epoch: int = -1
    history: list[dict[str, float]] = field(default_factory=list)
    # True when the run returned early on a caught termination signal
    # (utils.preemption.PreemptionGuard), after checkpointing.
    preempted: bool = False


def _make_val_decode_fn(model, val_dataset, cfg, device):
    """The validation decode function, built once a run."""
    v = val_dataset.vocab
    return make_decode_fn(model, cfg.decode, start_id=v.start, end_id=v.end,
                          pad_id=v.pad, device=device)


def _validate(model, state, val_dataset, cfg, decode_fn=None,
              device="cuda") -> dict[str, float]:
    """Decode and score the validation split, on the EMA weights when EMA
    is on, without external (JVM) scorers. Returns the evaluator's
    metrics plus the decode wall (``wall_s``) and ``score_s``, the rest of
    the call (scoring)."""
    params = ema_params(state)
    which = " (EMA weights)"
    if params is None:
        # A parameter object of its own: the decode caches packed weights
        # per object, and the training weights change in place.
        params = params_from_tensors(
            {n: t.detach() for n, t in named_tensors(state.params).items()},
            state.params)
        which = ""
    t0 = time.perf_counter()
    metrics = evaluate_split(
        model, params, val_dataset, cfg.decode, decode_fn=decode_fn,
        evaluator=CaptionEvaluator(use_external=False), device=device)
    metrics["score_s"] = time.perf_counter() - t0 - metrics["wall_s"]
    log.info("val metrics%s: %s", which,
             {k: round(v, 4) for k, v in metrics.items()})
    return metrics


def _pack_host_batches(host_batches, k: int, budget=None):
    """Group consecutive same-shape host batches into k-stacks for the
    multi-step function; odd ones out (bucket shape changes, epoch tails,
    the ``max_steps`` budget's tail) pass through as singles. Yields
    ("multi", stacked dict) with leaves [k, B, ...] or ("single", dict),
    never more than ``budget`` steps."""
    emitted = 0

    def _left():
        return float("inf") if budget is None else budget - emitted

    def _sig(hb):
        return tuple(sorted((key, np.shape(v)) for key, v in hb.items()))

    buf: list = []
    sig = None
    it = iter(host_batches)
    while True:
        hb = next(it, None)
        if hb is None or (buf and _sig(hb) != sig):
            for b in buf:
                if _left() <= 0:
                    return
                emitted += 1
                yield ("single", b)
            buf = []
        if hb is None or _left() <= 0:
            return
        buf.append(hb)
        sig = _sig(hb)
        if len(buf) == k:
            if _left() >= k:
                emitted += k
                yield ("multi", {key: np.stack([b[key] for b in buf])
                                 for key in buf[0]})
            else:
                for b in buf:
                    if _left() <= 0:
                        return
                    emitted += 1
                    yield ("single", b)
            buf = []


def _prefetch_packs(packs, device, size: int = 2):
    """The tagged-pack form of ``prefetch_to_device``: ("multi", leaves
    [k, B, ...]) or ("single", leaves [B, ...]) in the train step's dtypes,
    ``size`` packs ahead on ``device``."""
    return prefetch_to_device(
        ((kind, batch_host_tensors(hb)) for kind, hb in packs), size=size,
        device=device)


def _steps_per_epoch(dataset: CaptionDataset, batch_size: int) -> int:
    return -(-dataset.size // batch_size)


def run_xe_training(
    model: ModelDef,
    state: TrainState,
    cfg: CaptionKitConfig,
    train_dataset: CaptionDataset,
    val_dataset: Optional[CaptionDataset] = None,
    *,
    mesh=None,
    ckpt: Optional[CheckpointManager] = None,
    max_steps: Optional[int] = None,
    metrics_logger: Optional[MetricsLogger] = None,
    preemption=None,
    device: "str | torch.device" = "cuda",
) -> tuple[TrainState, TrainReport]:
    """The cross-entropy phase. ``max_steps`` bounds the steps of this
    call. ``preemption`` (a ``PreemptionGuard``) is polled between calls of
    the step: on a caught signal the loop drains, saves a checkpoint at the
    exact step, marks ``report.preempted`` and returns. ``device``: the
    card unless the caller names the CPU."""
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel training is not ported yet: pass mesh=None")
    dev = resolve_device(device)
    tcfg = cfg.train
    report = TrainReport()
    lr = tcfg.learning_rate
    epochs_since_best = 0
    k = max(1, int(tcfg.steps_per_dispatch))

    def build(rate):
        kw = dict(label_smoothing=tcfg.label_smoothing, learning_rate=rate)
        return (make_xe_train_step(model, tcfg, **kw),
                make_xe_train_multistep(model, tcfg, **kw) if k > 1 else None)

    step_fn, multi_fn = build(lr)
    val_decode_fn = (_make_val_decode_fn(model, val_dataset, cfg, dev)
                     if val_dataset is not None else None)
    steps_done = 0
    per_epoch = _steps_per_epoch(train_dataset, cfg.data.batch_size)
    start_epoch, skip = divmod(int(state.step), per_epoch)

    for epoch in range(start_epoch, tcfg.epochs):
        meter_loss, meter_acc, meter_bt, meter_tok = (
            AverageMeter(), AverageMeter(), AverageMeter(), AverageMeter())
        t0 = time.perf_counter()
        epoch_batches = train_dataset.batches(
            cfg.data.batch_size, shuffle=True, seed=tcfg.seed + epoch)
        if cfg.data.bucket_boundaries:
            from captionkit_torch.data.pipeline import bucket_batches

            epoch_batches = bucket_batches(epoch_batches,
                                           cfg.data.bucket_boundaries)
        host_batches = (_host_dict(b) for i, b in enumerate(epoch_batches)
                        if epoch > start_epoch or i >= skip)
        pending: list = []

        def _drain():
            for m in pending:
                for lo, ac, tk in zip(*(torch.atleast_1d(m[key]).cpu()
                                        .tolist() for key in
                                        ("loss", "top5_acc", "tokens"))):
                    meter_loss.update(lo)
                    meter_acc.update(ac)
                    meter_tok.update(tk)
            pending.clear()

        window_steps = 0
        steps_since_log = 0
        first_dispatch = True
        budget = None if max_steps is None else max_steps - steps_done
        packs = (_pack_host_batches(host_batches, k, budget) if k > 1
                 else (("single", hb) for hb in host_batches))
        for kind, dev_batch in _prefetch_packs(packs, dev):
            if preemption is not None and preemption.requested:
                break
            if kind == "multi":
                state, metrics = multi_fn(state, dev_batch)
                n = k
            else:
                state, metrics = step_fn(state, dev_batch)
                n = 1
            steps_done += n
            pending.append({key: metrics[key]
                            for key in ("loss", "top5_acc", "tokens")})
            window_steps += n
            steps_since_log += n
            # The first call carries the warm-up: drain and restart the
            # clock so it stays out of the steady-state rate.
            if first_dispatch:
                first_dispatch = False
                _drain()
                t0 = time.perf_counter()
                window_steps = steps_since_log = 0
            if steps_since_log >= tcfg.log_every:
                steps_since_log = 0
                _drain()  # reads the card, so the window is device time
                now = time.perf_counter()
                if window_steps:
                    meter_bt.update((now - t0) / window_steps,
                                    n=window_steps)
                t0 = now
                window_steps = 0
                log.info("epoch %d step %d loss %.4f top5 %.3f %.3fs/step",
                         epoch, state.step, meter_loss.avg, meter_acc.avg,
                         meter_bt.avg)
                if metrics_logger is not None:
                    sec = max(meter_bt.avg, 1e-9)
                    metrics_logger.log(state.step, {
                        "train/loss": meter_loss.avg,
                        "train/top5_acc": meter_acc.avg,
                        "train/sec_per_step": meter_bt.avg,
                        "train/tokens_per_sec": meter_tok.avg / sec,
                    })
            if max_steps is not None and steps_done >= max_steps:
                break
        _drain()
        if window_steps:
            meter_bt.update((time.perf_counter() - t0) / window_steps,
                            n=window_steps)

        if preemption is not None and preemption.requested:
            log.warning("preempted at step %d: checkpointing and exiting "
                        "cleanly", state.step)
            if ckpt is not None:
                ckpt.save(state, extra={"preempted": True})
            report.preempted = True
            report.epochs_run = epoch + 1
            report.history.append({"epoch": epoch, "loss": meter_loss.avg,
                                   "preempted": True})
            return state, report

        epoch_stats = {"epoch": epoch, "loss": meter_loss.avg,
                       "top5_acc": meter_acc.avg,
                       "sec_per_step": meter_bt.avg,
                       "tokens_per_step": meter_tok.avg}
        if val_dataset is not None and \
                (epoch + 1) % tcfg.eval_every_epochs == 0:
            vm = _validate(model, state, val_dataset, cfg, val_decode_fn,
                           dev)
            cider = vm.get("CIDEr", 0.0)
            epoch_stats.update(val_cider=cider, val_decode_s=vm["wall_s"],
                               val_score_s=vm["score_s"])
            if metrics_logger is not None:
                metrics_logger.log(state.step, {"val/cider": cider})
            if cider > report.best_metric:
                report.best_metric = cider
                report.best_epoch = epoch
                epochs_since_best = 0
            else:
                epochs_since_best += 1
            if ckpt is not None:
                ckpt.save(state, metric=cider)
            if epochs_since_best >= tcfg.early_stop_patience:
                log.info("early stop at epoch %d", epoch)
                report.history.append(epoch_stats)
                report.epochs_run = epoch + 1
                break
            if epochs_since_best > 0 and \
                    epochs_since_best % tcfg.lr_decay_patience == 0:
                lr *= tcfg.lr_decay_factor
                log.info("decaying lr to %g", lr)
                step_fn, multi_fn = build(lr)
        elif ckpt is not None:
            ckpt.save(state)
        report.history.append(epoch_stats)
        report.epochs_run = epoch + 1
        if max_steps is not None and steps_done >= max_steps:
            break
    return state, report


def _apply_pending(state, pending, update_fn, rewarder):
    """Finish a pipelined SCST step through the shared reward and update
    path."""
    dev_batch, refs, roll = pending
    return apply_rollout(update_fn=update_fn, rewarder=rewarder, state=state,
                         batch=dev_batch, references=refs, roll=roll)


def _seeded(*words: int) -> int:
    """A generator seed from integers, through ``numpy.random.SeedSequence``
    (independent streams for different words)."""
    return int(np.random.SeedSequence([int(w) for w in words])
               .generate_state(1, np.uint64)[0])


def run_scst_training(
    model: ModelDef,
    state: TrainState,
    cfg: CaptionKitConfig,
    train_dataset: CaptionDataset,
    val_dataset: Optional[CaptionDataset] = None,
    *,
    mesh=None,
    ckpt: Optional[CheckpointManager] = None,
    df: Optional[NgramDocFreq] = None,
    max_steps: Optional[int] = None,
    metrics_logger: Optional[MetricsLogger] = None,
    pipeline: bool = False,
    preemption=None,
    device: "str | torch.device" = "cuda",
) -> tuple[TrainState, TrainReport]:
    """The SCST fine-tuning phase, ``train.scst_epochs`` epochs at
    ``train.scst_learning_rate`` with ``train.scst_num_samples`` samples.

    Serial mode seeds each step's sampling generator from (rng_seed,
    step), as ``TrainState.next_generator`` does; pipelined mode from
    (rng_seed, epoch, rollouts enqueued this epoch), the reference's
    ``fold_in(fold_in(rng, epoch), dispatched)``. ``preemption`` is polled
    between steps: in pipelined mode the in-flight rollout is dropped (it
    changed no state), so the checkpoint is exact. Step metrics stay on
    the card until a log boundary."""
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel training is not ported yet: pass mesh=None")
    if train_dataset.references is None:
        raise ValueError("SCST needs per-image reference captions")
    dev = resolve_device(device)
    tcfg = cfg.train
    vocab = train_dataset.vocab
    if df is None:
        df = NgramDocFreq.build(train_dataset.references)
    rewarder = ScstRewarder(vocab, df)
    ref_ids = rewarder.intern(train_dataset.references)
    rollout_fn = make_scst_rollout(
        model, start_id=vocab.start, end_id=vocab.end, pad_id=vocab.pad,
        max_len=cfg.decode.max_decode_len,
        num_samples=tcfg.scst_num_samples)
    update_fn = make_scst_update(
        model, dataclasses.replace(tcfg,
                                   learning_rate=tcfg.scst_learning_rate),
        start_id=vocab.start, num_samples=tcfg.scst_num_samples)
    report = TrainReport()
    steps_done = 0
    val_decode_fn = (_make_val_decode_fn(model, val_dataset, cfg, dev)
                     if val_dataset is not None else None)

    def _prepared(batches):
        """(batch on the card, its images' interned references), two
        batches ahead."""
        return prefetch_to_device(
            ((batch_host_tensors(_host_dict(b)),
              [ref_ids[int(i)] for i in b.image_id]) for b in batches),
            device=dev)

    pending_metrics: list = []

    def _drain():
        # The progress signal: the masked mean advantage (sample - greedy)
        # for one sample; with n samples the leave-one-out advantages sum
        # to zero per image, so the samples' mean reward.
        for m in pending_metrics:
            meter_rw.update(float(m.get("reward_sample_mean",
                                        m["mean_advantage"])))
        pending_metrics.clear()

    def _tick(metrics, epoch):
        nonlocal steps_done
        steps_done += 1
        pending_metrics.append(metrics)
        if steps_done % tcfg.log_every == 0:
            _drain()
            multi = "reward_sample_mean" in metrics
            log.info("scst epoch %d step %d %s %.4f", epoch, steps_done,
                     "mean sample reward" if multi else "mean advantage",
                     meter_rw.avg)
            if metrics_logger is not None:
                key = ("scst/reward_sample_mean" if multi
                       else "scst/mean_advantage")
                metrics_logger.log(steps_done, {key: meter_rw.avg})

    def _done() -> bool:
        return max_steps is not None and steps_done >= max_steps

    for epoch in range(tcfg.scst_epochs):
        meter_rw = AverageMeter()
        batches = train_dataset.batches(
            cfg.data.batch_size, shuffle=True,
            seed=tcfg.seed + 1000 + epoch)
        if not pipeline:
            for dev_batch, refs in _prepared(batches):
                if preemption is not None and preemption.requested:
                    break
                state, metrics = scst_train_step(
                    rollout_fn=rollout_fn, update_fn=update_fn,
                    rewarder=rewarder, state=state, batch=dev_batch,
                    references=refs,
                    generator=state.next_generator(dev))
                _tick(metrics, epoch)
                if _done():
                    break
        else:
            # Batch k+1's rollout is enqueued (with the parameters from
            # before update k) before batch k's reward and update.
            pending = None  # (dev_batch, refs, roll)
            dispatched = 0  # rollouts enqueued this epoch
            for dev_batch, refs in _prepared(batches):
                if preemption is not None and preemption.requested:
                    pending = None  # not applied: no state changed
                    break
                gen = torch.Generator(device=dev).manual_seed(
                    _seeded(state.rng_seed, epoch, dispatched))
                dispatched += 1
                roll = rollout_fn(state.params, dev_batch, gen)
                if pending is not None:
                    state, metrics = _apply_pending(state, pending,
                                                    update_fn, rewarder)
                    _tick(metrics, epoch)
                    if _done():
                        pending = None
                        break
                pending = (dev_batch, refs, roll)
            if pending is not None and not _done():
                state, metrics = _apply_pending(state, pending, update_fn,
                                                rewarder)
                _tick(metrics, epoch)
        _drain()
        if preemption is not None and preemption.requested:
            log.warning("preempted at scst step %d: checkpointing and "
                        "exiting cleanly", steps_done)
            if ckpt is not None:
                ckpt.save(state, extra={"preempted": True})
            report.preempted = True
            report.epochs_run = epoch + 1
            report.history.append({"epoch": epoch,
                                   "mean_advantage": meter_rw.avg,
                                   "preempted": True})
            return state, report

        stats = {"epoch": epoch, "mean_advantage": meter_rw.avg}
        if val_dataset is not None:
            vm = _validate(model, state, val_dataset, cfg, val_decode_fn,
                           dev)
            cider = vm.get("CIDEr", 0.0)
            stats.update(val_cider=cider, val_decode_s=vm["wall_s"],
                         val_score_s=vm["score_s"])
            if cider > report.best_metric:
                report.best_metric = cider
                report.best_epoch = epoch
            if ckpt is not None:
                ckpt.save(state, metric=cider)
        elif ckpt is not None:
            ckpt.save(state)
        report.history.append(stats)
        report.epochs_run = epoch + 1
        if _done():
            break
    return state, report
