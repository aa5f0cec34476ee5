"""The decoder-step protocol shared by every model (``captionkit.models.base``).

A model is a ``ModelDef``: plain functions over explicit parameter objects.

* ``ctx``   — per-sequence static context, tensors [B, ...]
* ``state`` — recurrent state, a dataclass of tensors [B, ...]; beam search
              reorders it row by row, so every field's axis 0 is the batch
* ``step``  — (params, ctx, state, token [B], generator=None, train=False)
              -> (state, logits [B, V] fp32); ``train`` applies dropout
              with masks drawn from ``generator``
* ``step_attn`` — (params, ctx, state, token) -> (state, logits, attn):
              ``step``'s math on the plain cells plus the step's
              attention distributions (``decode/introspect.py``)

Random draws come from an explicit ``torch.Generator``, never from the
global one: the same generator state gives the same dropout masks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from captionkit_torch.config import ModelConfig
from captionkit_torch.kernels.head import (
    fused_head_topk,
    fused_head_topk_int8,
    kmajor_head,
    prepad_head,
    quantize_head,
    reference_head_topk,
    reference_head_topk_int8,
)


@dataclass(frozen=True)
class HeadInfo:
    """Static description of a model's vocab head: ``get_wb(params) ->
    (w [H, V], b [V])`` and the configured head dispatch."""

    get_wb: Callable[[Any], tuple[torch.Tensor, torch.Tensor]]
    impl: str = "pallas"  # "pallas" (the kernel) | "xla" (plain)
    quant: str = "none"
    compute_dtype: Any = torch.float32
    extract: str = "mask"


def prepared_head(w: torch.Tensor, b: torch.Tensor, info: HeadInfo) -> dict:
    """The head of w [H, V] and b [V] as ``info``'s head takes it, made once
    a batch (the context's ``head_*`` fields): int8, ``quantize_head``'s
    (w_q, scale, b) and the int8 kernel's K-major copy of w_q; the float
    kernel, w in the compute dtype and b, padded (``prepad_head``); the
    plain head, w in the compute dtype."""
    if info.quant == "int8":
        w_q, scale, b_p = quantize_head(w, b)
        return dict(head_w=w_q, head_b=b_p, head_scale=scale,
                    head_wt=kmajor_head(w_q))
    if info.impl == "xla":
        return dict(head_w=w.to(info.compute_dtype), head_b=b)
    w_p, b_p = prepad_head(w, b, compute_dtype=info.compute_dtype)
    return dict(head_w=w_p, head_b=b_p)


def head_topk(out: torch.Tensor, ctx: Any, k: int, info: HeadInfo):
    """(top-k logits, their vocab ids, log-sum-exp) of the hidden rows
    ``out`` [N, H] through ``ctx``'s prepared head (``prepared_head``):
    under ``quant="int8"`` the int8 kernel (``impl="xla"``: its plain
    version) on the fp32 rows, which it quantizes itself; else the float
    kernel with ``info.extract`` (``"xla"``: the plain full-logits head)."""
    if info.quant == "int8":
        h = out.float().contiguous()
        if info.impl == "xla":
            return reference_head_topk_int8(h, ctx.head_w, ctx.head_scale,
                                            ctx.head_b, k)
        return fused_head_topk_int8(h, ctx.head_w, ctx.head_scale,
                                    ctx.head_b, k=k, extract=info.extract,
                                    w_qt=ctx.head_wt)
    h = out.to(info.compute_dtype)
    if info.impl == "xla":
        return reference_head_topk(h, ctx.head_w, ctx.head_b, k)
    return fused_head_topk(h.contiguous(), ctx.head_w, ctx.head_b, k=k,
                           extract=info.extract)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    """The dtype the step's products round their operands to."""
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else \
        torch.float32


def head_info(cfg: ModelConfig) -> HeadInfo:
    """The configured vocab head of EditNet and DCNet (their params both
    hold it as ``fc_w``, ``fc_b``)."""
    return HeadInfo(get_wb=lambda p: (p.fc_w, p.fc_b), impl=cfg.head_impl,
                    quant=cfg.head_quant, compute_dtype=compute_dtype(cfg),
                    extract=cfg.head_extract)


def prepare_head(params, cfg: ModelConfig, ctx):
    """The per-batch head of a model's ``prepare_topk`` (``prepared_head``:
    int8 quantized once a batch with its K-major copy, as the reference's
    ``prepare_topk`` quantizes; the float kernel's padded head; the plain
    head in the compute dtype)."""
    return ctx.replace(**prepared_head(params.fc_w, params.fc_b,
                                       head_info(cfg)))


def configured_head_topk(params, cfg: ModelConfig, ctx, out: torch.Tensor,
                         k: int):
    """The vocab-head top-k (``head_topk``) on the prepared head, made here
    when ``prepare_topk`` did not run."""
    if ctx.head_w is None:
        ctx = prepare_head(params, cfg, ctx)
    return head_topk(out, ctx, k, head_info(cfg))


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
    # (params, ctx, state, token) -> (state, h [B, H]): the step's
    # recurrent math stopped before the vocab head, without dropout. The
    # ensemble runs it per member and puts its own head after it.
    step_hidden: Optional[Callable[..., tuple[Any, torch.Tensor]]] = None
    # (params, ctx) -> ctx: the fused-cell pack that ``prepare_topk``
    # builds when the config runs the cell kernels (unchanged ctx when it
    # does not), without the head; the ensemble prepares its members with
    # it and keeps one combined head.
    prepare_cells: Optional[Callable[[Any, Any], Any]] = None
    # (params, ctx, state, token) -> (state, logits [B, V] fp32, attn):
    # ``step`` (without dropout) through the plain cells, plus a dict of
    # the step's attention distributions, fp32 [B, N]. Key convention:
    # "vis_alpha" is over the regions; "alpha" and "beta" are over the
    # existing caption's positions (they resolve to source words).
    step_attn: Optional[Callable[..., tuple[Any, torch.Tensor, dict]]] = None


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
