"""The decoder-step protocol shared by every model (``captionkit.models.base``).

A model is a ``ModelDef``: plain functions over explicit parameter objects.

* ``ctx``   — per-sequence static context, tensors [B, ...]
* ``state`` — recurrent state, a dataclass of tensors [B, ...]; beam search
              reorders it row by row, so every field's axis 0 is the batch
* ``step``  — (params, ctx, state, token [B]) -> (state, logits [B, V] fp32)
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
