"""Caption-editing server: JSON-lines micro-batching over one resident
model (``captionkit.serve``).

Requests queue until the batch fills (or a flush, the ``flush_ms`` bound
or EOF drains the queue); each drained batch pads only up to the smallest
ladder rung that fits, by repeating its last row, and only the first
``len(requests)`` outputs are answered. Batches are submitted without
waiting for their tokens (``submit_batch``/``collect``, up to
``max_in_flight`` outstanding), so the stream loop keeps reading and
tokenizing while the card decodes.

Protocol (one JSON object per line):
  request:  {"id": <any>, "caption": "existing caption to edit",
             "features": "path.npy of [R, F]"}          (or)
            {"id": ..., "caption": ..., "features_inline": [[...]]}
  control:  {"flush": true}    decode whatever is queued now
  response: {"id": <same>, "caption": "<edited caption>"}
            {"id": <same>, "error": "<what was wrong>"}
Startup emits {"ready": true, "batch": N, "ladder": [...]}.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from captionkit_torch.config import CaptionKitConfig
from captionkit_torch.data.featquant import quantize_for_feed
from captionkit_torch.decode.driver import make_decode_fn
from captionkit_torch.device import resolve_device


class CaptionServer:
    """Holds the decode function, the weights and the vocab; stateless per
    request."""

    def __init__(self, cfg: CaptionKitConfig, params: Any, model, vocab,
                 *, ladder: Sequence[int] = (), decode_fn=None,
                 device: "str | torch.device" = "cuda"):
        """``decode_fn`` replaces the default decode (``make_decode_fn``:
        beam, greedy or sampling, as ``cfg.decode`` says) with any
        (params, feats, ids [b, T], lens [b], step) -> tokens callable of
        the same contract; feats [b, R, F] arrive staged for
        ``decode.feed_dtype`` (``quantize_for_feed``: the (q, scale) pair
        for "int8")."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.vocab = vocab
        self.params = params
        self.batch = cfg.decode.batch_size
        sizes = sorted({int(s) for s in ladder} | {self.batch})
        if any(s < 1 or s > self.batch for s in sizes):
            raise ValueError(
                f"ladder sizes must be in [1, {self.batch}]: {sizes}")
        self.ladder = tuple(sizes)
        self.max_existing_len = cfg.data.max_existing_len
        self.num_regions = cfg.model.num_regions
        self.feat_dim = cfg.model.feat_dim
        self._feed_dtype = cfg.decode.feed_dtype
        self._decode_fn = decode_fn if decode_fn is not None else \
            make_decode_fn(model, cfg.decode, start_id=vocab.start,
                           end_id=vocab.end, pad_id=vocab.pad,
                           device=self.device)

    def _rung(self, b: int) -> int:
        return next(s for s in self.ladder if s >= b)

    def warmup(self) -> None:
        """Run every ladder rung once on dummy rows before serving."""
        feats = np.zeros((1, self.num_regions, self.feat_dim), np.float32)
        for s in self.ladder:
            self.run_batch(np.repeat(feats, s, axis=0), ["<unk>"] * s)

    def submit_batch(self, feats: np.ndarray, captions: Sequence[str]
                     ) -> tuple[Any, int]:
        """Tokenize and launch a batch without waiting for its tokens.
        feats [b, R, F] fp32, b <= self.batch; the tail pads by repeating
        the last row up to the smallest rung that fits, then the batch is
        staged for ``decode.feed_dtype`` (quantized per region for
        "int8"). Returns a handle for ``collect``."""
        b = len(captions)
        target = self._rung(b)
        pad = target - b
        if pad:
            feats = np.concatenate([feats] + [feats[-1:]] * pad, axis=0)
        T = self.max_existing_len
        ids = np.zeros((target, T), np.int64)
        lens = np.zeros((target,), np.int64)
        for i in range(target):
            enc, ln = self.vocab.encode(captions[min(i, b - 1)].split(),
                                        max_len=T)
            ids[i] = enc
            lens[i] = ln
        tokens_dev = self._decode_fn(
            self.params, quantize_for_feed(feats, self._feed_dtype),
            torch.from_numpy(ids), torch.from_numpy(lens), 0)
        return tokens_dev, b

    def collect(self, handle: tuple[Any, int]) -> list[str]:
        """Wait for a ``submit_batch`` handle; returns its b captions."""
        tokens_dev, b = handle
        tokens = tokens_dev.cpu().numpy()
        return [self.vocab.decode_to_string(tokens[i]) for i in range(b)]

    def run_batch(self, feats: np.ndarray, captions: Sequence[str]
                  ) -> list[str]:
        """Submit and collect one batch."""
        return self.collect(self.submit_batch(feats, captions))


def serve_stream(
    server: CaptionServer,
    in_stream,
    out_stream,
    *,
    flush_ms: Optional[float] = None,
    max_in_flight: int = 2,
) -> int:
    """Drive the JSON-lines protocol until EOF. Returns requests served.

    ``flush_ms``: the longest a queued request waits for its batch to fill
    before a partial batch is decoded anyway (a reader thread keeps the
    wait off the input stream). Without it, partial batches drain only on
    {"flush": true} or EOF.

    ``max_in_flight``: submitted but uncollected batches; responses leave
    in batch order."""
    if max_in_flight < 1:
        raise ValueError("max_in_flight must be >= 1")
    R, F = server.num_regions, server.feat_dim
    pending: list[tuple] = []
    oldest_ts = 0.0  # monotonic arrival time of pending[0]
    in_flight: list[tuple] = []  # (handle, [request ids]) FIFO
    served = 0

    def emit(obj) -> None:
        out_stream.write(json.dumps(obj) + "\n")
        out_stream.flush()

    def drain_one() -> None:
        nonlocal served
        handle, rids = in_flight.pop(0)
        for rid, cap in zip(rids, server.collect(handle)):
            emit({"id": rid, "caption": cap})
            served += 1

    def submit() -> None:
        if not pending:
            return
        while len(in_flight) >= max_in_flight:
            drain_one()
        feats = np.stack([p[1] for p in pending])
        caps = [p[2] for p in pending]
        rids = [p[0] for p in pending]
        in_flight.append((server.submit_batch(feats, caps), rids))
        pending.clear()

    def flush() -> None:
        submit()
        while in_flight:
            drain_one()

    def handle(line: str) -> None:
        nonlocal oldest_ts
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            emit({"error": f"bad JSON: {e}"})
            return
        if req.get("flush"):
            flush()
            return
        try:
            if "features_inline" in req:
                feats = np.asarray(req["features_inline"], np.float32)
            else:
                feats = np.load(req["features"]).astype(np.float32)
        except Exception as e:  # a bad path or payload is answered
            emit({"id": req.get("id"), "error": f"features: {e}"})
            return
        if feats.ndim == 3 and feats.shape[0] == 1:
            feats = feats[0]
        if feats.shape != (R, F):
            emit({"id": req.get("id"),
                  "error": f"features must be [{R}, {F}], "
                           f"got {list(feats.shape)}"})
            return
        if not pending:
            oldest_ts = time.monotonic()
        pending.append((req.get("id"), feats, req.get("caption", "")))
        if len(pending) >= server.batch:
            submit()

    emit({"ready": True, "batch": server.batch,
          "ladder": list(server.ladder)})

    if flush_ms is None:
        for line in in_stream:
            line = line.strip()
            if line:
                handle(line)
        flush()
        return served

    q: queue.Queue = queue.Queue()
    eof = object()

    def reader() -> None:
        for line in in_stream:
            q.put(line)
        q.put(eof)

    threading.Thread(target=reader, daemon=True).start()
    while True:
        if pending:
            # The bound is on the oldest queued request's whole wait.
            waited = time.monotonic() - oldest_ts
            timeout: Optional[float] = max(0.0, flush_ms / 1000.0 - waited)
        elif in_flight:
            timeout = 0.0  # answer in-flight batches before blocking
        else:
            timeout = None
        try:
            item = q.get(timeout=timeout)
        except queue.Empty:
            if pending:
                flush()
            elif in_flight:
                drain_one()
            continue
        if item is not eof:
            line = item.strip()
            if line:
                handle(line)
        # Also checked after handling: a stream of lines that never fills
        # a batch keeps q.get returning, so the timeout alone never fires.
        if pending and time.monotonic() - oldest_ts >= flush_ms / 1000.0:
            flush()
        if item is eof:
            break
    flush()
    return served
