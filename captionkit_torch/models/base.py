"""The decoder-step protocol shared by every model (``captionkit.models.base``).

A model is a ``ModelDef``: plain functions over explicit parameter objects.

* ``ctx``   — per-sequence static context, tensors [B, ...]
* ``state`` — recurrent state, a dataclass of tensors [B, ...]; beam search
              reorders it row by row, so every field's axis 0 is the batch
* ``step``  — (params, ctx, state, token [B], generator=None, train=False)
              -> (state, logits [B, V] fp32); ``train`` applies dropout
              with masks drawn from ``generator``

Random draws come from an explicit ``torch.Generator``, never from the
global one: the same generator state gives the same dropout masks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch


@dataclass(frozen=True)
class HeadInfo:
    """Static description of a model's vocab head: ``get_wb(params) ->
    (w [H, V], b [V])`` and the configured head dispatch."""

    get_wb: Callable[[Any], tuple[torch.Tensor, torch.Tensor]]
    impl: str = "pallas"  # "pallas" (the kernel) | "xla" (plain)
    quant: str = "none"
    compute_dtype: Any = torch.float32
    extract: str = "mask"


@dataclass(frozen=True)
class ModelDef:
    """A caption editor: encode once, then step a token at a time."""

    name: str
    init: Callable[..., Any]  # (seed, device) -> params
    encode: Callable[..., Any]  # (params, features, existing, existing_len)
    init_state: Callable[..., Any]  # (params, ctx) -> state
    step: Callable[..., tuple[Any, torch.Tensor]]
    # (ctx, k) -> ctx with only the per-beam leaves repeated.
    beam_expand: Optional[Callable[[Any, int], Any]] = None
    # (params, ctx, state, token, k) -> (state, top_vals [B, k] fp32 raw
    # logits, top_idx [B, k] int32, lse [B] fp32): the fused head.
    step_topk: Optional[Callable[..., Any]] = None
    # (params, ctx, k) -> ctx: decode-loop-invariant head preparation,
    # called once per batch before the loop.
    prepare_topk: Optional[Callable[[Any, Any, int], Any]] = None
    head_info: Optional[HeadInfo] = None
    # (params, ctx, state0, tokens_in [B, T], generator=None, train=False)
    # -> logits [B, T, V] fp32: teacher forcing with the state-independent
    # work (the embedding gather, the input side of the gate product, the
    # vocab head) outside the recurrence; row for row the math of a loop
    # of ``step``.
    forward_seq: Optional[Callable[..., torch.Tensor]] = None


def default_generator(generator: Optional[torch.Generator],
                      device) -> torch.Generator:
    """``generator``, or one seeded with 0 on ``device`` (the reference's
    ``PRNGKey(0)`` when teacher forcing gets no key)."""
    if generator is not None:
        return generator
    return torch.Generator(device=device).manual_seed(0)


def teacher_forcing_logits(model: ModelDef, params: Any, ctx: Any,
                           state: Any, tokens_in: torch.Tensor, *,
                           generator: Optional[torch.Generator] = None,
                           train: bool = False) -> torch.Tensor:
    """Logits [B, T, V] over the gold inputs (``<start> w1 .. w_{T-1}``):
    ``logits[:, t]`` predicts the token after ``tokens_in[:, t]``. Takes
    the model's ``forward_seq`` when it has one, else a loop of ``step``
    (dropout masks drawn step by step from ``generator``)."""
    if model.forward_seq is not None:
        return model.forward_seq(params, ctx, state, tokens_in,
                                 generator=generator, train=train)
    if train:
        generator = default_generator(generator, tokens_in.device)
    out = []
    for t in range(tokens_in.shape[1]):
        state, logits = model.step(params, ctx, state, tokens_in[:, t],
                                   generator=generator, train=train)
        out.append(logits)
    return torch.stack(out, dim=1)


def dropout_mask(shape, rate: float, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """The keep mask of inverted dropout: bool, True with probability
    1 - rate (a uniform draw below 1 - rate, as ``jax.random.bernoulli``
    draws it), from ``generator``."""
    u = torch.rand(shape, generator=generator, device=device)
    return u < (1.0 - rate)


def apply_dropout_mask(x: torch.Tensor, keep: torch.Tensor,
                       rate: float) -> torch.Tensor:
    """``where(keep, x / (1 - rate), 0)``."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator], train: bool
            ) -> torch.Tensor:
    """Inverted dropout; the identity when not training, at rate 0 or
    without a generator (as the reference's without a key)."""
    if not train or rate <= 0.0 or generator is None:
        return x
    return apply_dropout_mask(
        x, dropout_mask(x.shape, rate, generator, x.device), rate)
