"""Split-decode driver (``captionkit.decode.driver``).

``make_decode_fn`` builds the (params, features, existing, existing_len,
batch_idx) -> tokens [B, L] function; ``decode_split`` streams a dataset
split through it batch by batch, dispatching batch k+1 before it reads
batch k's tokens back, and drops the padding rows of the last batch on
the host. Only beam search is ported; greedy and sampling raise.
"""

from __future__ import annotations

import collections
import json
import time
from typing import Any, Optional

import numpy as np
import torch

from captionkit_torch.config import DecodeConfig
from captionkit_torch.data.featquant import (
    dequantize_for_feed,
    feed_to_device,
    feed_torch_dtype,
    quantize_for_feed,
)
from captionkit_torch.data.sources import CaptionDataset
from captionkit_torch.decode.beam import beam_search
from captionkit_torch.device import resolve_device
from captionkit_torch.models.base import ModelDef


def make_decode_fn(
    model: ModelDef,
    decode_cfg: DecodeConfig,
    *,
    start_id: int,
    end_id: int,
    pad_id: int = 0,
    device: "str | torch.device" = "cuda",
):
    """(params, features, existing, existing_len, batch_idx) -> tokens
    [B, L] int32 on ``device``. The inputs may sit on the host; they are
    moved to ``device`` here. ``features`` is staged as
    ``quantize_for_feed`` stages it for ``decode_cfg.feed_dtype``: with
    "int8", the (q, scale) pair, dequantized on the device before
    ``encode``."""
    if decode_cfg.method in ("greedy", "sample"):
        raise NotImplementedError(
            f"decode method {decode_cfg.method!r} is not yet ported; "
            "use method='beam'")
    if decode_cfg.method != "beam":
        raise ValueError(f"unknown decode method {decode_cfg.method!r}")
    if decode_cfg.beam_size < 2:
        raise NotImplementedError(
            "beam_size 1 decodes greedily in the reference; greedy is not "
            "yet ported")
    feed_torch_dtype(decode_cfg.feed_dtype)
    dev = resolve_device(device)

    @torch.inference_mode()
    def fn(params, features, existing, existing_len, batch_idx=0):
        del batch_idx  # the seed offset of sampling, which is not ported
        features = dequantize_for_feed(feed_to_device(features, dev),
                                       decode_cfg.feed_dtype)
        ctx = model.encode(params, features, existing.to(dev),
                           existing_len.to(dev))
        return beam_search(
            model, params, ctx,
            beam_size=decode_cfg.beam_size,
            start_id=start_id, end_id=end_id, pad_id=pad_id,
            max_len=decode_cfg.max_decode_len,
            length_penalty=decode_cfg.length_penalty,
            impl=decode_cfg.beam_impl,
        ).tokens

    return fn


def decode_split(
    model: ModelDef,
    params: Any,
    dataset: CaptionDataset,
    decode_cfg: DecodeConfig,
    *,
    decode_fn=None,
    results_path: Optional[str] = None,
    device: "str | torch.device" = "cuda",
) -> tuple[dict[int, str], dict[str, float]]:
    """Decode a dataset split. Returns ({image_id: caption}, stats); stats
    holds the captions decoded, the wall seconds of the whole split and
    the captions/s of the batches after the first (0.0 when the split is
    one batch: the first batch carries the warm-up)."""
    vocab = dataset.vocab
    dev = resolve_device(device)
    if decode_fn is None:
        decode_fn = make_decode_fn(
            model, decode_cfg, start_id=vocab.start, end_id=vocab.end,
            pad_id=vocab.pad, device=dev)
    hypotheses: dict[int, str] = {}
    n_decoded = 0
    n_timed = 0
    t_start: Optional[float] = None
    pending: collections.deque = collections.deque()

    def _consume() -> None:
        nonlocal n_decoded, n_timed, t_start
        tokens_dev, batch = pending.popleft()
        tokens = tokens_dev.cpu().numpy()
        n_valid = int(batch.valid.sum())
        if t_start is None:
            t_start = time.perf_counter()
        else:
            n_timed += n_valid
        for row, valid, img in zip(tokens, batch.valid, batch.image_id):
            if not valid:
                continue
            hypotheses[int(img)] = vocab.decode_to_string(row)
            n_decoded += 1

    t_total = time.perf_counter()
    for batch_idx, batch in enumerate(dataset.batches(decode_cfg.batch_size)):
        tokens_dev = decode_fn(
            params,
            quantize_for_feed(batch.features, decode_cfg.feed_dtype),
            torch.from_numpy(np.asarray(batch.existing, np.int64)),
            torch.from_numpy(np.asarray(batch.existing_len, np.int64)),
            batch_idx,
        )
        pending.append((tokens_dev, batch))
        if len(pending) > 2:
            _consume()
    while pending:
        _consume()
    elapsed = time.perf_counter() - (t_start or time.perf_counter())
    stats = {
        "captions": float(n_decoded),
        "wall_s": time.perf_counter() - t_total,
        "captions_per_sec": n_timed / elapsed if elapsed > 0 and n_timed
        else 0.0,
    }
    if results_path:
        ids = dataset.image_ids
        with open(results_path, "w") as f:
            json.dump(
                [{"image_id": int(ids[k]) if ids is not None else k,
                  "caption": v}
                 for k, v in sorted(hypotheses.items())],
                f, indent=0)
    return hypotheses, stats
