"""Stacked editing: DCNet's output becomes EditNet's existing caption
(``captionkit.decode.stacked``).

The two editors are trained apart and combined by running one after the
other: DCNet encodes and decodes the incoming caption, its tokens are
re-wrapped as an existing caption, and EditNet edits that caption against
the image. The intermediate caption stays on the card. Either stage may be
a checkpoint ensemble (``models/ensemble.py``).
"""

from __future__ import annotations

from typing import Any

import torch

from captionkit_torch.config import DecodeConfig
from captionkit_torch.data.featquant import (
    dequantize_for_feed,
    feed_to_device,
    feed_torch_dtype,
)
from captionkit_torch.decode.beam import beam_search
from captionkit_torch.decode.greedy import greedy_decode
from captionkit_torch.device import resolve_device
from captionkit_torch.models.base import ModelDef


def rollout_to_existing(tokens: torch.Tensor,  # [B, L] (pad after <end>)
                        lengths: torch.Tensor,  # [B] emitted, incl. <end>
                        *, start_id: int, pad_id: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """A rollout as encoder-format existing captions, ``<start> w1 ...
    <end> <pad>...`` [B, L+1] (a full-length rollout is never cut), and
    their lengths + 1, int32."""
    start = torch.full((tokens.shape[0], 1), start_id, dtype=torch.int32,
                       device=tokens.device)
    existing = torch.cat([start, tokens.to(torch.int32)], dim=1)
    return existing, lengths.to(torch.int32) + 1


def make_stacked_decode_fn(
    dcnet: ModelDef,
    editnet: ModelDef,
    *,
    first_stage: DecodeConfig,
    second_stage: DecodeConfig,
    start_id: int,
    end_id: int,
    pad_id: int = 0,
    feed_dtype: str = "float32",
    device: "str | torch.device" = "cuda",
):
    """(dcnet_params, editnet_params, features, existing, existing_len) ->
    the second stage's tokens [B, L] on ``device``. Each stage decodes
    greedy, or beam when its config says beam with ``beam_size > 1``.
    ``features`` are staged as ``quantize_for_feed`` stages them for
    ``feed_dtype`` ("int8": the (q, scale) pair), copied to the card once
    and dequantized there; both stages see the same features."""
    for stage in (first_stage, second_stage):
        if stage.method not in ("greedy", "beam"):
            raise ValueError(f"stacked decode supports greedy/beam stages, "
                             f"got {stage.method!r}")
    feed_torch_dtype(feed_dtype)
    dev = resolve_device(device)

    def _decode(model, params, ctx, cfg: DecodeConfig):
        if cfg.method == "beam" and cfg.beam_size > 1:
            res = beam_search(model, params, ctx, beam_size=cfg.beam_size,
                              start_id=start_id, end_id=end_id,
                              pad_id=pad_id, max_len=cfg.max_decode_len,
                              length_penalty=cfg.length_penalty,
                              impl=cfg.beam_impl)
            return res.tokens, res.lengths
        out = greedy_decode(model, params, ctx, start_id=start_id,
                            end_id=end_id, pad_id=pad_id,
                            max_len=cfg.max_decode_len)
        return out.tokens, out.lengths

    @torch.inference_mode()
    def fn(dcnet_params: Any, editnet_params: Any, features,
           existing: torch.Tensor, existing_len: torch.Tensor
           ) -> torch.Tensor:
        features = dequantize_for_feed(feed_to_device(features, dev),
                                       feed_dtype)
        existing, existing_len = existing.to(dev), existing_len.to(dev)
        # Stage 1: DCNet edits the incoming caption (text only).
        ctx1 = dcnet.encode(dcnet_params, features, existing, existing_len)
        toks1, lens1 = _decode(dcnet, dcnet_params, ctx1, first_stage)
        exist2, exist2_len = rollout_to_existing(
            toks1, lens1, start_id=start_id, pad_id=pad_id)
        # Stage 2: EditNet edits DCNet's output, grounded in the image.
        ctx2 = editnet.encode(editnet_params, features, exist2, exist2_len)
        toks2, _ = _decode(editnet, editnet_params, ctx2, second_stage)
        return toks2

    return fn
