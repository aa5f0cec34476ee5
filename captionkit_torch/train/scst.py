"""SCST, self-critical sequence training (``captionkit.train.scst``).

After cross-entropy training, each image gets a sampled caption and a
greedy baseline caption; the reward is CIDEr-D(sample) - CIDEr-D(greedy)
and the loss is the REINFORCE surrogate -reward · log p(sampled).

A step has three parts, as in the reference:

1. the rollout (card): one encode feeds the sample leg and the greedy leg
   (``make_scst_rollout``), under ``torch.no_grad`` so no graph of the 2 x
   ``max_len`` steps is kept. The sampled tokens start their copy to the
   host as soon as the rollout is enqueued, so the reward of a batch can
   run while the card still works on what was enqueued after it;
2. the reward (host): ids to words, then the native CIDEr-D against a
   precomputed document-frequency table, both legs (or all n samples) in
   one native call (``ScstRewarder``);
3. the update (card): the surrogate recomputed by teacher forcing on the
   sampled tokens (``make_scst_update``), the same gradient as
   differentiating the rollout, then the optimizer chain.

With ``num_samples = n > 1`` the rollout draws n samples in sequence and
no greedy leg, and each sample's baseline is the mean reward of its n - 1
siblings (``ScstRewarder.advantage_loo``).

With a mesh (``parallel/mesh.py``) each rank rolls out, rewards and
updates its rows of the global batch: the update's token count, valid rows
and advantage sum are summed over the ranks before the forward, the
gradients after it, so ``num``, ``den`` and ``adv_mean`` are the global
batch's; the sample axis of ``num_samples = n`` is not split, so the
leave-one-out baseline stays with its image. The reward of a row depends
only on that row (the document frequencies are the split's), and the
reward metrics are summed over the ranks on the host.

Samples come from a ``torch.Generator``: draws from the same distribution
as the reference's, not its ``jax.random`` samples. On a mesh the loop
adds the rank to each generator's seed words, so no two ranks draw the
same samples (numpy's ``SeedSequence`` pads its words with zeros: rank 0
draws what one process draws). The rewarder raises
when the native scorer cannot be built, where the reference steps down to
the Python ``CiderD``.

Under ``--debug-nans`` the rollout's and the update's floating-point
outputs are checked once a call (``utils.logging.check_nans``), as the
reference's jit checks them.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from captionkit_torch.config import TrainConfig
from captionkit_torch.data.vocab import UNK_TOKEN, Vocab
from captionkit_torch.decode.greedy import greedy_decode, sample_decode
from captionkit_torch.metrics.cider import NgramDocFreq
from captionkit_torch.metrics.fast import NativeCiderD
from captionkit_torch.models.base import ModelDef, teacher_forcing_logits
from captionkit_torch.params import named_tensors, params_from_tensors
from captionkit_torch.train.state import TrainState, make_optimizer
from captionkit_torch.parallel.mesh import all_reduce_, host_sum
from captionkit_torch.train.xe import global_norm
from captionkit_torch.utils.logging import check_nans


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` on the host, started now and not waited for (pinned
    memory) when ``t`` is on the card."""
    if t.device.type != "cuda":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def host_tokens(roll: dict, key: str) -> np.ndarray:
    """The rollout's ``key`` tokens on the host, waiting only for the
    copy the rollout started (not for work enqueued after it)."""
    if roll.get("ready") is not None:
        roll["ready"].synchronize()
    return roll["host"][key].numpy()


def make_scst_rollout(model: ModelDef, *, start_id: int, end_id: int,
                      pad_id: int = 0, max_len: int = 22, mesh=None,
                      num_samples: int = 1):
    """(params, batch, generator) -> rollout dict.

    ``num_samples=1``: one sampled and one greedy caption per image, from
    one encode: ``sample_tokens``, ``sample_mask``, ``greedy_tokens``,
    ``greedy_mask`` [B, L]. ``num_samples=n>1``: n samples drawn in
    sequence from ``generator``, no greedy leg: [n, B, L]. The dict also
    holds ``host`` (the token tensors' host copies) and ``ready`` (the
    CUDA event after them, None on the CPU): read them with
    ``host_tokens``.

    The rollout reads ``params`` through a parameter object of its own, so
    its packed weights are built from the values the parameters have when
    the rollout is enqueued; an update enqueued after it, which changes the
    parameters in place, does not reach it. With ``mesh`` the batch is
    this rank's rows and ``generator`` this rank's (the rollout itself
    needs no collective)."""
    ids = dict(start_id=start_id, end_id=end_id, pad_id=pad_id,
               max_len=max_len)

    @torch.no_grad()
    def fn(params, batch, generator: torch.Generator) -> dict:
        params = params_from_tensors(
            {n: t.detach() for n, t in named_tensors(params).items()},
            params)
        ctx = model.encode(params, batch["features"], batch["existing"],
                           batch["existing_len"])
        if num_samples == 1:
            sample = sample_decode(model, params, ctx, generator, **ids)
            greedy = greedy_decode(model, params, ctx, **ids)
            out = {"sample_tokens": sample.tokens,
                   "sample_mask": sample.mask,
                   "greedy_tokens": greedy.tokens,
                   "greedy_mask": greedy.mask}
            keys = ("sample_tokens", "greedy_tokens")
        else:
            draws = [sample_decode(model, params, ctx, generator, **ids)
                     for _ in range(num_samples)]
            out = {"sample_tokens": torch.stack([d.tokens for d in draws]),
                   "sample_mask": torch.stack([d.mask for d in draws])}
            keys = ("sample_tokens",)
        check_nans("scst_rollout", out)
        out["host"] = {k: _host_copy(out[k]) for k in keys}
        out["ready"] = None
        if out["sample_tokens"].device.type == "cuda":
            out["ready"] = torch.cuda.Event()
            out["ready"].record()
        return out

    return fn


def make_scst_update(model: ModelDef, cfg: TrainConfig, *, start_id: int,
                     mesh=None, num_samples: int = 1):
    """(TrainState, batch, sampled tokens, sample mask, advantage) ->
    (TrainState, metrics). Tokens and mask are [B, L] ([n, B, L] with
    ``num_samples>1``), the advantage [B] ([n, B]), on the card. The loss
    is the per-token mean of -advantage · log p(sampled token) over the
    valid rows' emitted tokens, by teacher forcing without dropout. One
    encode feeds every sample; each sample's surrogate runs its own
    backward and the gradients add up, so the peak memory stays at one
    sample's (the denominator comes from the masks before any forward).
    Parameters and optimizer state are updated in place; the metrics
    (``scst_loss``, ``mean_advantage``, ``sample_len``, ``grad_norm``)
    stay on the card. The optimizer steps at ``cfg.learning_rate`` (the
    loop passes ``cfg`` with ``scst_learning_rate`` there). With ``mesh``
    the inputs are this rank's rows and the metrics the global batch's."""
    tx = make_optimizer(cfg)

    def step_fn(state: TrainState, batch: dict, tokens: torch.Tensor,
                mask: torch.Tensor, advantage: torch.Tensor):
        if num_samples == 1:
            tokens, mask, advantage = tokens[None], mask[None], \
                advantage[None]
        named = named_tensors(state.params)
        leaves = list(named.values())
        valid = batch["valid"].float()
        n, B = tokens.shape[0], tokens.shape[1]
        maskf = mask.float() * valid[None, :, None]
        den = maskf.sum()
        n_valid = valid.sum()
        adv_sum = (advantage * valid[None, :]).sum()
        if mesh is not None:
            totals = all_reduce_(mesh, [torch.stack([den, n_valid,
                                                     adv_sum])])[0]
            den, n_valid, adv_sum = totals[0], totals[1], totals[2]
        scale = den.clamp(min=1.0)
        rows = (n * n_valid).clamp(min=1.0)
        ctx = model.encode(state.params, batch["features"],
                           batch["existing"], batch["existing_len"])
        state0 = model.init_state(state.params, ctx)
        start = torch.full((B, 1), start_id, dtype=tokens.dtype,
                           device=tokens.device)
        grads = [None] * len(leaves)
        num_total = torch.zeros((), device=tokens.device)
        for i in range(n):
            tokens_in = torch.cat([start, tokens[i, :, :-1]], dim=1)
            logits = teacher_forcing_logits(model, state.params, ctx, state0,
                                            tokens_in, train=False)
            logp = torch.log_softmax(logits.float(), dim=-1)
            tok_logp = torch.gather(logp, 2,
                                    tokens[i].long()[..., None])[..., 0]
            num = torch.sum(-advantage[i][:, None] * tok_logp * maskf[i])
            g = torch.autograd.grad(num / scale, leaves,
                                    retain_graph=i < n - 1,
                                    allow_unused=True)
            grads = [a if b is None else b if a is None else a + b
                     for a, b in zip(grads, g)]
            num_total = num_total + num.detach()
            del logits, logp, tok_logp, num, g
        grads = {name: torch.zeros_like(t) if g is None else g
                 for (name, t), g in zip(named.items(), grads)}
        if mesh is not None:
            num_total = num_total.reshape(1)
            all_reduce_(mesh, [*grads.values(), num_total])
            num_total = num_total[0]
        tx.update(grads, state.opt_state, state.params)
        metrics = {
            "scst_loss": num_total / scale,
            "mean_advantage": adv_sum / rows,
            "sample_len": den / rows,
            "grad_norm": global_norm(grads.values()),
        }
        state = TrainState(params=state.params, opt_state=state.opt_state,
                           step=state.step + 1, rng_seed=state.rng_seed)
        check_nans("scst_update", {"state": state, "metrics": metrics})
        return state, metrics

    return step_fn


class ScstRewarder:
    """Host CIDEr-D advantage, sample reward minus the greedy baseline,
    against a precomputed document-frequency table (rewards do not depend
    on the batch). Scores with ``NativeCiderD``; its build failing raises.
    References come as ``intern``'s ids (the loop interns the training
    set's once), and every hypothesis set of a call is scored in one
    native call against them (``NativeCiderD.score_sets``: each image's
    reference vectors built once, the scores bit-equal to scoring the sets
    one by one)."""

    def __init__(self, vocab: Vocab, df: NgramDocFreq):
        self.vocab = vocab
        self._native = NativeCiderD(df)
        n = max(vocab.id2word, default=-1) + 1
        self._words = np.array([vocab.id2word.get(i, UNK_TOKEN)
                                for i in range(n)], dtype=object)

    def _decode(self, tokens: np.ndarray) -> list[list[str]]:
        """``Vocab.decode`` of every row (stop at <end>, drop <start> and
        <pad>), by array lookups."""
        t = np.asarray(tokens)
        v = self.vocab
        if t.size and (t.min() < 0 or t.max() >= len(self._words)):
            return [v.decode(row) for row in t]
        is_end = t == v.end
        stop = np.where(is_end.any(axis=1), is_end.argmax(axis=1),
                        t.shape[1])
        keep = ((np.arange(t.shape[1])[None, :] < stop[:, None])
                & (t != v.pad) & (t != v.start))
        return [self._words[row[k]].tolist() for row, k in zip(t, keep)]

    def intern(self, references: Sequence[Sequence[Sequence[str]]]
               ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Each image's references as the ids ``advantage`` takes."""
        return self._native.intern_references(references)

    def advantage(self, sample_tokens: np.ndarray,  # [B, L]
                  greedy_tokens: np.ndarray,  # [B, L]
                  reference_ids: Sequence[tuple[np.ndarray, np.ndarray]]
                  ) -> np.ndarray:
        r_s, r_g = self._native.score_sets(
            [self._decode(sample_tokens), self._decode(greedy_tokens)],
            reference_ids)
        return (r_s - r_g).astype(np.float32)

    def advantage_loo(self, sample_tokens: np.ndarray,  # [n, B, L]
                      reference_ids: Sequence[tuple[np.ndarray, np.ndarray]]
                      ) -> tuple[np.ndarray, np.ndarray]:
        """Each sample's reward minus the mean reward of its n - 1
        siblings. Returns (advantage [n, B], rewards [n, B])."""
        n, B, _ = sample_tokens.shape
        if n < 2:
            raise ValueError("advantage_loo needs num_samples >= 2")
        r = self._native.score_sets([self._decode(t) for t in sample_tokens],
                                    reference_ids)
        rewards = r.astype(np.float32)
        baseline = (rewards.sum(axis=0, keepdims=True) - rewards) / (n - 1)
        return (rewards - baseline).astype(np.float32), rewards


def _host_mean(values: np.ndarray, mesh) -> float:
    """The mean of ``values`` over every rank's rows."""
    if mesh is None:
        return float(values.mean())
    total, count = host_sum(mesh, [float(values.astype(np.float64).sum()),
                                   values.size])
    return total / count


def apply_rollout(*, update_fn, rewarder: ScstRewarder, state: TrainState,
                  batch: dict, references, roll: dict, mesh=None
                  ) -> tuple[TrainState, dict[str, Any]]:
    """Finish a step from an enqueued rollout: the host reward, then the
    update. [B, L] samples take the greedy baseline, [n, B, L] the
    leave-one-out one; ``references`` are the batch's images' ids from
    ``rewarder.intern``. Shared by the serial and pipelined loops. With
    ``mesh`` each rank rewards its rows; the reward metrics are the global
    batch's."""
    sample_tokens = host_tokens(roll, "sample_tokens")
    dev = roll["sample_tokens"].device
    if sample_tokens.ndim == 3:
        adv, rewards = rewarder.advantage_loo(sample_tokens, references)
        new_state, metrics = update_fn(
            state, batch, roll["sample_tokens"], roll["sample_mask"],
            torch.from_numpy(adv).to(dev))
        metrics = dict(metrics)
        metrics["reward_sample_mean"] = _host_mean(rewards, mesh)
        return new_state, metrics
    adv = rewarder.advantage(sample_tokens, host_tokens(roll,
                                                        "greedy_tokens"),
                             references)
    new_state, metrics = update_fn(
        state, batch, roll["sample_tokens"], roll["sample_mask"],
        torch.from_numpy(adv).to(dev))
    metrics = dict(metrics)
    # The raw (unmasked) mean; ``mean_advantage`` is the valid-row one.
    metrics["reward_sample_minus_greedy"] = _host_mean(adv, mesh)
    return new_state, metrics


def scst_train_step(*, rollout_fn, update_fn, rewarder: ScstRewarder,
                    state: TrainState, batch: dict, references,
                    generator: torch.Generator, mesh=None
                    ) -> tuple[TrainState, dict[str, Any]]:
    """One whole SCST step: rollout, host reward, update."""
    roll = rollout_fn(state.params, batch, generator)
    return apply_rollout(update_fn=update_fn, rewarder=rewarder, state=state,
                         batch=batch, references=references, roll=roll,
                         mesh=mesh)
