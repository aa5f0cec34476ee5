"""Train state: parameters, optimizer state, step counter and the dropout
generator's seed (``captionkit.train.state``).

The reference builds its optimizer from optax: ``optax.clip`` (a clamp of
every gradient element to [-grad_clip, grad_clip], not a global-norm clip),
then Adam, AdamW or SGD, then, with ``ema_decay > 0``, an EMA of the
post-update parameters kept in the optimizer state. ``make_optimizer``
writes out the same formulas with ``torch._foreach`` ops, in optax's
order:

* Adam (b1 0.9, b2 0.999, eps 1e-8): mu = (1-b1) g + b1 mu,
  nu = (1-b2) g² + b2 nu, count += 1,
  update = -lr · (mu / (1-b1^count)) / (sqrt(nu / (1-b2^count)) + eps);
* AdamW: Adam's direction plus 1e-4 · params (optax's default weight
  decay), times -lr;
* SGD: -lr · g;
* EMA: ema = decay · ema + (1-decay) · params after the update; its
  initial value is a copy of the initial parameters, never the same
  tensors.

``torch.optim.Adam`` computes the same formula but rounds in another
order (a lerp for the first moment, the bias correction folded into the
denominator), so it is not used.

Dropout draws: the reference folds the step into its key
(``fold_in(rng, step)``); here ``next_generator`` seeds a
``torch.Generator`` from ``(rng_seed, step)``, so the masks of a step
depend only on the seed and the step, and a resumed run draws what the
uninterrupted one drew. On a mesh every rank draws the global batch's
masks from that generator and keeps its rows (``models.base.RowShare``);
the SCST samples of a mesh are seeded from (rng_seed, step, rank)
instead (rank 0's equal one process's: ``SeedSequence`` pads its words
with zeros).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from captionkit_torch.config import TrainConfig
from captionkit_torch.params import named_tensors, params_from_tensors

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
ADAMW_WEIGHT_DECAY = 1e-4


@dataclass
class OptState:
    """The optimizer's state, by parameter name: Adam's moments and step
    count (empty for SGD), and the EMA parameters (None when EMA is off)."""

    count: int = 0
    mu: dict = dataclasses.field(default_factory=dict)
    nu: dict = dataclasses.field(default_factory=dict)
    ema: Optional[dict] = None


@dataclass
class TrainState:
    params: Any  # EditNetParams | DCNetParams, fp32 leaf tensors
    opt_state: OptState
    step: int
    rng_seed: int  # the dropout generator's seed (see next_generator)

    def next_generator(self, device: "str | torch.device",
                       rank: Optional[int] = None) -> torch.Generator:
        """The generator of this step's dropout masks, seeded from
        (rng_seed, step): resume-stable. ``rank`` adds a third word, for
        draws that must differ between ranks (the SCST samples of a
        mesh)."""
        words = [int(self.rng_seed), int(self.step)]
        if rank is not None:
            words.append(int(rank))
        seed = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
        return torch.Generator(device=device).manual_seed(int(seed))


class Optimizer:
    """Element clip, then Adam / AdamW / SGD, then the optional EMA
    (``captionkit.train.state.make_optimizer``'s chain).

    ``init(params) -> OptState``; ``update(grads, opt_state, params)``
    applies the step to ``params``' tensors in place and advances
    ``opt_state`` in place. ``grads`` is a dict by parameter name."""

    def __init__(self, cfg: TrainConfig, learning_rate: Optional[float] = None):
        if cfg.optimizer not in ("adam", "adamw", "sgd"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        ema_decay = getattr(cfg, "ema_decay", 0.0)
        if ema_decay != 0.0 and not (0.0 < ema_decay < 1.0):
            raise ValueError(
                f"train.ema_decay must be 0 (off) or in (0, 1), got "
                f"{ema_decay}")
        self.kind = cfg.optimizer
        self.clip = float(cfg.grad_clip)
        self.lr = float(cfg.learning_rate if learning_rate is None
                        else learning_rate)
        self.ema_decay = float(ema_decay)

    def init(self, params) -> OptState:
        named = named_tensors(params)
        st = OptState()
        if self.kind in ("adam", "adamw"):
            st.mu = {n: torch.zeros_like(t) for n, t in named.items()}
            st.nu = {n: torch.zeros_like(t) for n, t in named.items()}
        if self.ema_decay > 0.0:
            st.ema = {n: t.detach().clone() for n, t in named.items()}
        return st

    @torch.no_grad()
    def update(self, grads: dict, opt_state: OptState, params) -> None:
        named = named_tensors(params)
        names = list(named)
        p = [named[n].data for n in names]
        g = [grads[n] for n in names]
        if self.clip > 0:
            g = torch._foreach_clamp_max(torch._foreach_clamp_min(
                g, -self.clip), self.clip)
        if self.kind == "sgd":
            upd = torch._foreach_mul(g, -self.lr)
        else:
            mu = [opt_state.mu[n] for n in names]
            nu = [opt_state.nu[n] for n in names]
            torch._foreach_mul_(mu, ADAM_B1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - ADAM_B1))
            torch._foreach_mul_(nu, ADAM_B2)
            torch._foreach_add_(nu, torch._foreach_mul(
                torch._foreach_mul(g, g), 1.0 - ADAM_B2))
            opt_state.count += 1
            # optax's bias corrections: 1 - decay**count in float32
            bc1, bc2 = (float(np.float32(1.0) - np.float32(b) ** np.float32(
                opt_state.count)) for b in (ADAM_B1, ADAM_B2))
            den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(den, ADAM_EPS)
            upd = torch._foreach_div(torch._foreach_div(mu, bc1), den)
            if self.kind == "adamw":
                torch._foreach_add_(upd, torch._foreach_mul(
                    p, ADAMW_WEIGHT_DECAY))
            torch._foreach_mul_(upd, -self.lr)
        torch._foreach_add_(p, upd)
        if opt_state.ema is not None:
            ema = [opt_state.ema[n] for n in names]
            torch._foreach_mul_(ema, self.ema_decay)
            torch._foreach_add_(ema, torch._foreach_mul(
                p, 1.0 - self.ema_decay))


def make_optimizer(cfg: TrainConfig,
                   learning_rate: Optional[float] = None) -> Optimizer:
    """The reference's optimizer chain for ``cfg`` (``learning_rate``
    overrides ``cfg.learning_rate``: the loop's decayed lr)."""
    return Optimizer(cfg, learning_rate)


def ema_params(state: TrainState):
    """The EMA parameters as a parameter object (fresh packed-weight
    caches), or None when training runs without EMA."""
    if state.opt_state.ema is None:
        return None
    return params_from_tensors(state.opt_state.ema, state.params)


def trainable(params) -> Any:
    """``params`` with every weight a float32 leaf tensor that requires a
    gradient (copies of the given tensors), in a new parameter object."""
    return params_from_tensors(
        {n: t.detach().float().clone().requires_grad_(True)
         for n, t in named_tensors(params).items()}, params)


def create_train_state(init_params_fn: Callable[[int], Any],
                       cfg: TrainConfig, *,
                       seed: Optional[int] = None) -> TrainState:
    """Parameters from ``init_params_fn(param_seed)``, optimizer state,
    step 0 and the dropout seed, both seeds drawn from ``seed`` (default
    ``cfg.seed``) as the reference splits its key in two."""
    seed = cfg.seed if seed is None else seed
    param_seed, rng_seed = (int(x) for x in np.random.SeedSequence(
        int(seed)).generate_state(2, np.uint32))
    params = trainable(init_params_fn(param_seed))
    return TrainState(params=params,
                      opt_state=make_optimizer(cfg).init(params),
                      step=0, rng_seed=rng_seed)


def broadcast_train_state(mesh, state: TrainState) -> TrainState:
    """Rank 0's parameters and optimizer tensors (Adam's moments, the EMA)
    copied in place to every rank of ``mesh``, in one flat broadcast: the
    replicated start of data-parallel training. The step, the seed and
    Adam's count must already agree (the same config or checkpoint)."""
    from captionkit_torch.parallel.mesh import broadcast_

    st = state.opt_state
    tensors = list(named_tensors(state.params).values())
    for d in (st.mu, st.nu, st.ema or {}):
        tensors.extend(d.values())
    broadcast_(mesh, tensors)
    return state
