"""Split-decode driver (``captionkit.decode.driver``).

``make_decode_fn`` builds the (params, features, existing, existing_len,
batch_idx) -> tokens [B, L] function; ``decode_split`` streams a dataset
split through it batch by batch, dispatching batch k+1 before it reads
batch k's tokens back, and drops the padding rows of the last batch on
the host; ``evaluate_split`` scores the decoded split against its
references (``metrics.eval.CaptionEvaluator``). The method is the
reference's choice: beam search when ``method="beam"`` and
``beam_size > 1``, sampling for ``"sample"``, else greedy.

With a mesh (``parallel/mesh.py``) every rank iterates the split's
batches in the same order, gathers and decodes only its rows of each
(the int8 feed's (q, scale) pair split alike), and the token rows, with
their image ids and valid flags, are gathered to every rank through the
host, where they go for detokenization anyway: every rank returns the
whole split's hypotheses.

On a CUDA device with the float32 feed, each batch's features are
gathered straight into a slot of a ring of two pinned host buffers of the
batch's shape ([B, R, F], or [B/W, R, F] a rank with a mesh), made once
a process (``featquant.pinned_feed_ring``), and the decode function
copies them to the card without blocking. A slot is rewritten only after
the CUDA event that ``feed_to_device`` records right after the copy out
of it: the gather of batch k + 2 waits for the copy of batch k, not for
batch k's search. Other devices and feeds gather each batch into a fresh
array.

Inside a profiler session (``utils/profiling.py``) the driver records
spans: ``split.gather`` (the split's row gather), ``split.dispatch`` (the
decode call), ``split.consume`` with ``split.readback`` and
``split.detokenize``, and, inside the decode function,
``decode.feed_copy``, ``decode.encode`` and ``decode.search``; the
read-back also reads the device counters the steps kept
(``profiling.flush_device``).
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
    pinned_feed_ring,
    quantize_for_feed,
)
from captionkit_torch.data.sources import CaptionDataset
from captionkit_torch.decode.beam import beam_search
from captionkit_torch.decode.greedy import greedy_decode, sample_decode
from captionkit_torch.device import resolve_device
from captionkit_torch.metrics.eval import CaptionEvaluator
from captionkit_torch.models.base import ModelDef
from captionkit_torch.parallel.mesh import gather_rows
from captionkit_torch.utils.profiling import annotate, flush_device


def make_decode_fn(
    model: ModelDef,
    decode_cfg: DecodeConfig,
    *,
    start_id: int,
    end_id: int,
    pad_id: int = 0,
    device: "str | torch.device" = "cuda",
    mesh=None,
):
    """(params, features, existing, existing_len, batch_idx) -> tokens
    [B, L] int32 on ``device``. The inputs may sit on the host; they are
    moved to ``device`` here. ``features`` is staged as
    ``quantize_for_feed`` stages it for ``decode_cfg.feed_dtype``: with
    "int8", the (q, scale) pair, dequantized on the device before
    ``encode``. Sampling seeds its generator from ``decode_cfg.seed`` and
    ``batch_idx`` (``sample_seed``). With ``mesh`` the inputs are this
    rank's rows (``shard_batch_arrays``), the tokens are theirs, on the
    rank's device, and a sampling decode adds the rank to the seed."""
    if decode_cfg.method not in ("greedy", "beam", "sample"):
        raise ValueError(f"unknown decode method {decode_cfg.method!r}")
    feed_torch_dtype(decode_cfg.feed_dtype)
    dev = resolve_device(device) if mesh is None else mesh.device
    rank = () if mesh is None else (mesh.rank,)
    ids = dict(start_id=start_id, end_id=end_id, pad_id=pad_id,
               max_len=decode_cfg.max_decode_len)

    @torch.inference_mode()
    def fn(params, features, existing, existing_len, batch_idx=0):
        with annotate("decode.feed_copy"):
            features = dequantize_for_feed(feed_to_device(features, dev),
                                           decode_cfg.feed_dtype)
        with annotate("decode.encode"):
            ctx = model.encode(params, features, existing.to(dev),
                               existing_len.to(dev))
        with annotate("decode.search"):
            if decode_cfg.method == "beam" and decode_cfg.beam_size > 1:
                return beam_search(
                    model, params, ctx,
                    beam_size=decode_cfg.beam_size,
                    length_penalty=decode_cfg.length_penalty,
                    impl=decode_cfg.beam_impl, **ids,
                ).tokens
            if decode_cfg.method == "sample":
                gen = torch.Generator(device=dev).manual_seed(
                    sample_seed(decode_cfg.seed, batch_idx, *rank))
                return sample_decode(
                    model, params, ctx, gen,
                    temperature=decode_cfg.temperature,
                    top_k=decode_cfg.top_k, top_p=decode_cfg.top_p,
                    **ids).tokens
            return greedy_decode(model, params, ctx, **ids).tokens

    return fn


def sample_seed(seed: int, batch_idx: int, *rank: int) -> int:
    """The generator seed of batch ``batch_idx`` of a sampling decode: the
    reference folds the batch index into its key; here the numbers (and
    the rank on a mesh) feed one
    ``numpy.random.SeedSequence``, so batches and ranks draw independent
    streams."""
    return int(np.random.SeedSequence([int(seed), int(batch_idx),
                                       *map(int, rank)])
               .generate_state(1, np.uint64)[0])


def decode_split(
    model: ModelDef,
    params: Any,
    dataset: CaptionDataset,
    decode_cfg: DecodeConfig,
    *,
    decode_fn=None,
    results_path: Optional[str] = None,
    device: "str | torch.device" = "cuda",
    mesh=None,
) -> tuple[dict[int, str], dict[str, float]]:
    """Decode a dataset split. Returns ({image_id: caption}, stats); stats
    holds the captions decoded, the wall seconds of the whole split and
    the captions/s of the batches after the first (0.0 when the split is
    one batch: the first batch carries the warm-up). With ``mesh`` each
    rank decodes its rows of every batch and every rank returns the whole
    split's captions (only rank 0 writes ``results_path``)."""
    vocab = dataset.vocab
    dev = resolve_device(device) if mesh is None else mesh.device
    if decode_fn is None:
        decode_fn = make_decode_fn(
            model, decode_cfg, start_id=vocab.start, end_id=vocab.end,
            pad_id=vocab.pad, device=dev, mesh=mesh)
    hypotheses: dict[int, str] = {}
    n_decoded = 0
    n_timed = 0
    t_start: Optional[float] = None
    pending: collections.deque = collections.deque()

    def _consume() -> None:
        nonlocal n_decoded, n_timed, t_start
        tokens_dev, batch = pending.popleft()
        with annotate("split.consume"):
            with annotate("split.readback"):
                tokens = tokens_dev.cpu().numpy()
                flush_device()  # the step counters, with the tokens' read
                valid_rows, image_ids = batch.valid, batch.image_id
                if mesh is not None:
                    rows = gather_rows(mesh, np.concatenate(
                        [tokens.astype(np.int64), image_ids[:, None],
                         valid_rows[:, None]], axis=1))
                    tokens = rows[:, :-2].astype(tokens.dtype)
                    image_ids = rows[:, -2]
                    valid_rows = rows[:, -1].astype(bool)
            n_valid = int(valid_rows.sum())
            if t_start is None:
                t_start = time.perf_counter()
            else:
                n_timed += n_valid
            with annotate("split.detokenize"):
                for row, valid, img in zip(tokens, valid_rows, image_ids):
                    if not valid:
                        continue
                    hypotheses[int(img)] = vocab.decode_to_string(row)
                    n_decoded += 1

    t_total = time.perf_counter()
    # An explicit iterator, so that the gather each next() does is a span
    # of its own (and no span covers the generator's final return).
    share = None if mesh is None else mesh.share
    ring = None
    if (dev.type == "cuda" and decode_cfg.feed_dtype == "float32"
            and dataset.features is not None):
        rows = decode_cfg.batch_size // (1 if share is None else share[1])
        ring = pinned_feed_ring(dev, (rows, *dataset.features.shape[1:]))
    batches = dataset.batches(
        decode_cfg.batch_size, share=share,
        feature_out=None if ring is None else ring.acquire)
    n_batches = -(-dataset.size // decode_cfg.batch_size)
    for batch_idx in range(n_batches):
        with annotate("split.gather"):
            batch = next(batches, None)
        if batch is None:
            raise RuntimeError(f"the split gave {batch_idx} batches, not "
                               f"{n_batches}")
        with annotate("split.dispatch"):
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
    if next(batches, None) is not None:
        raise RuntimeError(f"the split gave more than {n_batches} batches")
    while pending:
        _consume()
    elapsed = time.perf_counter() - (t_start or time.perf_counter())
    stats = {
        "captions": float(n_decoded),
        "wall_s": time.perf_counter() - t_total,
        "captions_per_sec": n_timed / elapsed if elapsed > 0 and n_timed
        else 0.0,
    }
    if results_path and (mesh is None or mesh.is_main):
        ids = dataset.image_ids
        with open(results_path, "w") as f:
            json.dump(
                [{"image_id": int(ids[k]) if ids is not None else k,
                  "caption": v}
                 for k, v in sorted(hypotheses.items())],
                f, indent=0)
    return hypotheses, stats


def evaluate_split(
    model: ModelDef,
    params: Any,
    dataset: CaptionDataset,
    decode_cfg: DecodeConfig,
    *,
    evaluator: Optional[CaptionEvaluator] = None,
    results_path: Optional[str] = None,
    decode_fn=None,
    device: "str | torch.device" = "cuda",
    mesh=None,
) -> dict[str, float]:
    """Decode a split and score it against ``dataset.references``: the
    evaluator's metrics and ``decode_split``'s stats in one dict. Pass a
    prebuilt ``decode_fn`` to reuse it across repeated validations. With
    ``mesh`` the decode is split by rows and every rank scores the whole
    split's captions (the same numbers on every rank)."""
    if dataset.references is None:
        raise ValueError("dataset has no reference captions to score against")
    hyps, stats = decode_split(
        model, params, dataset, decode_cfg, results_path=results_path,
        decode_fn=decode_fn, device=device, mesh=mesh)
    refs = {
        int(img): [" ".join(toks) for toks in dataset.references[int(img)]]
        for img in hyps
    }
    evaluator = evaluator or CaptionEvaluator()
    metrics = evaluator.evaluate(refs, hyps)
    metrics.update(stats)
    return metrics
