"""Cross-entropy (teacher-forcing) training step (``captionkit.train.xe``).

Teacher forcing through the model's ``forward_seq``, the masked
cross-entropy over the caption's real steps, then the reference's
optimizer chain (element clip, Adam, optional EMA; ``train.state``).

With a mesh (``parallel/mesh.py``) each rank takes its rows of the global
batch. The token count of the global batch is summed over the ranks
before the forward, so each rank's loss is its masked NLL sum over the
global count; the gradients (and the metric sums, in the same flat
buffer) are then summed, and the optimizer runs the same on every rank.
Dropout draws the global batch's masks from the (seed, step) generator
and keeps the rank's rows (``models.base.RowShare``), so W ranks follow
the trajectory of one rank on the same batches.

A step returns its metrics as device tensors (loss, top-5 accuracy,
tokens, the gradient's global norm): nothing here reads a value back to
the host, so the caller decides when to synchronize. Under
``--debug-nans`` each call (a step, a k-step pack, an eval loss) checks
its outputs once (``utils.logging.check_nans``), as the reference's jit
does: the new state, which was updated in place, and the metrics.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from captionkit_torch.config import TrainConfig
from captionkit_torch.models.base import (
    ModelDef,
    RowShare,
    teacher_forcing_logits,
)
from captionkit_torch.nn.masking import masked_cross_entropy, top5_accuracy
from captionkit_torch.parallel.mesh import all_reduce_
from captionkit_torch.params import named_tensors
from captionkit_torch.train.state import TrainState, make_optimizer
from captionkit_torch.utils.logging import check_nans

BATCH_KEYS = ("features", "existing", "existing_len", "target",
              "target_len", "valid")


def _global_tokens(batch: dict, mesh) -> torch.Tensor:
    """The masked steps of the global batch (``xe_loss``'s mask: the first
    ``target_len - 1`` steps of each valid row) as a float32 scalar: this
    rank's count summed over the ranks."""
    steps = batch["target"].shape[1] - 1
    n = (batch["target_len"] - 1).clamp(0, steps) * batch["valid"]
    return all_reduce_(mesh, [n.sum().float()])[0]


def _reduce_metrics(mesh, metrics: dict, tensors=()) -> None:
    """Sum ``loss`` and ``top5_acc`` (this rank's shares of the global
    means) over the ranks, with ``tensors`` in the same flat buffer."""
    sums = torch.stack([metrics["loss"], metrics["top5_acc"]])
    all_reduce_(mesh, [*tensors, sums])
    metrics["loss"], metrics["top5_acc"] = sums[0], sums[1]


def xe_loss(model: ModelDef, params: Any,
            features: torch.Tensor,  # [B, R, F]
            existing: torch.Tensor,  # [B, T_in]
            existing_len: torch.Tensor,  # [B]
            target: torch.Tensor,  # [B, T_out] <start> w1 .. <end> <pad>..
            target_len: torch.Tensor,  # [B]
            valid: torch.Tensor,  # [B] bool: padding rows of a tail batch
            *, generator: "torch.Generator | RowShare | None" = None,
            train: bool = True, label_smoothing: float = 0.0,
            denominator: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Masked cross-entropy and top-5 accuracy on one batch; with
    ``denominator`` (the global batch's token count) both are this
    batch's share of the global means, and ``tokens`` is the global count.
    """
    ctx = model.encode(params, features, existing, existing_len)
    state0 = model.init_state(params, ctx)
    tokens_in, labels = target[:, :-1], target[:, 1:]
    logits = teacher_forcing_logits(model, params, ctx, state0, tokens_in,
                                    generator=generator, train=train)
    steps = torch.arange(labels.shape[1], device=labels.device)[None, :]
    mask = (steps < (target_len[:, None] - 1)) & valid[:, None]
    loss = masked_cross_entropy(logits, labels, mask,
                                label_smoothing=label_smoothing,
                                denominator=denominator)
    with torch.no_grad():
        acc = top5_accuracy(logits, labels, mask, denominator=denominator)
    tokens = mask.sum() if denominator is None else denominator
    return loss, {"loss": loss.detach(), "top5_acc": acc,
                  "tokens": tokens.to(torch.int32)}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every element's square (``optax.global_norm``)."""
    return torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))


def _xe_step_body(model: ModelDef, tx, label_smoothing: float, mesh=None):
    """(TrainState, batch) -> (TrainState, metrics): the body shared by the
    single-step and multi-step builders."""

    def step_fn(state: TrainState, batch: dict):
        named = named_tensors(state.params)
        dev = batch["target"].device
        gen = state.next_generator(dev)
        count = None
        if mesh is not None:
            gen = RowShare(gen, mesh.rank, mesh.size)
            count = _global_tokens(batch, mesh)
        loss, metrics = xe_loss(
            model, state.params, *(batch[k] for k in BATCH_KEYS),
            generator=gen, train=True, label_smoothing=label_smoothing,
            denominator=count)
        leaves = list(named.values())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = {n: torch.zeros_like(t) if g is None else g
                 for (n, t), g in zip(named.items(), grads)}
        metrics = dict(metrics)
        if mesh is not None:
            _reduce_metrics(mesh, metrics, grads.values())
        tx.update(grads, state.opt_state, state.params)
        metrics["grad_norm"] = global_norm(grads.values())
        return TrainState(params=state.params, opt_state=state.opt_state,
                          step=state.step + 1,
                          rng_seed=state.rng_seed), metrics

    return step_fn


def make_xe_train_step(model: ModelDef, cfg: TrainConfig, mesh=None, *,
                       label_smoothing: float = 0.0,
                       learning_rate: Optional[float] = None):
    """(TrainState, batch dict) -> (TrainState, metrics). The batch holds
    ``BATCH_KEYS`` as tensors on the card (``batch_to_device_dict``); with
    ``mesh``, this rank's rows of the global batch (``shard_batch_arrays``)
    and the metrics are the global batch's. The state's parameter and
    optimizer tensors are updated in place (the reference donates them).
    ``learning_rate`` overrides ``cfg.learning_rate``."""
    body = _xe_step_body(model, make_optimizer(cfg, learning_rate),
                         label_smoothing, mesh)

    def step_fn(state: TrainState, batch: dict):
        state, metrics = body(state, batch)
        check_nans("xe_train_step", {"state": state, "metrics": metrics})
        return state, metrics

    return step_fn


def make_xe_train_multistep(model: ModelDef, cfg: TrainConfig, mesh=None,
                            *, label_smoothing: float = 0.0,
                            learning_rate: Optional[float] = None):
    """k train steps in one call over stacked batches (leaves [k, B, ...];
    with ``mesh``, this rank's rows of each, ``shard_batch_arrays(...,
    stacked=True)``): the same body as ``make_xe_train_step`` k times, each
    step with its own dropout generator from (rng_seed, step), so the
    result equals k single steps. Metrics come back stacked, [k] each."""
    step_fn = _xe_step_body(model, make_optimizer(cfg, learning_rate),
                            label_smoothing, mesh)

    def multi_fn(state: TrainState, batches: dict):
        k = batches["target"].shape[0]
        out = []
        for j in range(k):
            state, m = step_fn(state, {key: v[j] for key, v in
                                       batches.items()})
            out.append(m)
        metrics = {key: torch.stack([m[key] for m in out])
                   for key in out[0]}
        check_nans("xe_train_multistep",
                   {"state": state, "metrics": metrics})
        return state, metrics

    return multi_fn


def make_eval_loss_step(model: ModelDef, mesh=None):
    """(params, batch) -> metrics: the loss without dropout or update; with
    ``mesh``, the global batch's from this rank's rows."""

    @torch.no_grad()
    def step_fn(params, batch):
        count = None if mesh is None else _global_tokens(batch, mesh)
        _, metrics = xe_loss(model, params, *(batch[k] for k in BATCH_KEYS),
                             generator=None, train=False, denominator=count)
        if mesh is not None:
            _reduce_metrics(mesh, metrics)
        check_nans("eval_loss_step", metrics)
        return metrics

    return step_fn


def batch_host_tensors(batch) -> dict:
    """``data.Batch`` (or its host dict, or a k-stack of them) -> the
    ``BATCH_KEYS`` as host tensors in the train step's dtypes (features
    float32, ids int64, ``valid`` bool)."""
    get = batch.get if isinstance(batch, dict) else \
        (lambda k: getattr(batch, k))
    out = {}
    for k in BATCH_KEYS:
        a = np.asarray(get(k))
        t = torch.from_numpy(np.ascontiguousarray(a))
        if k == "features":
            t = t.float()
        elif k == "valid":
            t = t.bool()
        else:
            t = t.long()
        out[k] = t
    return out


def batch_to_device_dict(batch, device: "str | torch.device") -> dict:
    """``batch_host_tensors`` on ``device``: the dict the train step takes,
    copied synchronously from pageable memory (the loops use
    ``data/prefetch.py`` instead)."""
    return {k: t.to(device, non_blocking=True)
            for k, t in batch_host_tensors(batch).items()}
