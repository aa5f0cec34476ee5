"""Static-shape batching (a copy of ``captionkit.data.pipeline``).

Host-side NumPy. ``Batch`` arrays have the same shapes for a given config;
pad id is 0; true lengths ride along as int32 arrays; the final ragged
batch of a split is padded up to ``batch_size`` with repeated rows and a
validity mask.
"""

from __future__ import annotations

import os
from collections.abc import Callable, Iterator, Sequence
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class Batch:
    """One device batch. All arrays NumPy, static-shaped.

    features:      [B, R, F] float32
    existing:      [B, L_in] int32     existing caption ids
    existing_len:  [B] int32
    target:        [B, L_out] int32    gold caption ids (training only)
    target_len:    [B] int32
    valid:         [B] bool            False for padding rows in final batch
    image_id:      [B] int32
    """

    features: np.ndarray
    existing: np.ndarray
    existing_len: np.ndarray
    target: Optional[np.ndarray]
    target_len: Optional[np.ndarray]
    valid: np.ndarray
    image_id: np.ndarray

    @property
    def size(self) -> int:
        return int(self.existing.shape[0])


def pad_to(ids: Sequence[int], length: int, pad: int = 0) -> np.ndarray:
    arr = np.full((length,), pad, dtype=np.int32)
    n = min(len(ids), length)
    arr[:n] = np.asarray(ids[:n], dtype=np.int32)
    return arr


def encode_captions(
    token_seqs: Sequence[Sequence[str]],
    vocab,
    max_len: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Encode tokenized captions into [N, max_len] ids + [N] lengths."""
    n = len(token_seqs)
    ids = np.zeros((n, max_len), dtype=np.int32)
    lens = np.zeros((n,), dtype=np.int32)
    for k, toks in enumerate(token_seqs):
        row, length = vocab.encode(toks, max_len)
        ids[k] = np.asarray(row, dtype=np.int32)
        lens[k] = length
    return ids, lens


# Threads of ``take_rows``: numpy's take releases the interpreter lock, and
# on the 8-core host of an H100 a 302 MB batch gathered in 67 ms on one
# thread and in 14 ms over 8.
_TAKE_THREADS = min(8, os.cpu_count() or 1)


def take_rows(src: np.ndarray, rows, out: np.ndarray) -> np.ndarray:
    """``out[...] = src[rows]`` with no temporary: ``np.take`` along axis 0
    straight into ``out``, its rows split over a few threads. The mode is
    "clip", since the default "raise" buffers ``out`` through a temporary;
    the bounds are checked here first, so an out-of-range row still
    raises, and a negative row counts from the end, as ``src[rows]`` has
    it. Another dtype than ``src``'s is filled by a cast of ``src[rows]``."""
    rows = np.asarray(rows, np.intp)
    n = src.shape[0]
    if rows.size and (rows.min() < -n or rows.max() >= n):
        raise IndexError(f"row index out of range [-{n}, {n})")
    if out.dtype != src.dtype:
        out[...] = src[rows]
        return out
    rows = np.where(rows < 0, rows + n, rows)
    bounds = np.linspace(0, len(rows), min(_TAKE_THREADS, len(rows)) + 1,
                         dtype=np.intp)

    def part(lo: int, hi: int) -> None:
        np.take(src, rows[lo:hi], axis=0, out=out[lo:hi], mode="clip")

    if len(bounds) <= 2:
        part(0, len(rows))
        return out
    with ThreadPoolExecutor(len(bounds) - 1) as pool:
        for done in [pool.submit(part, lo, hi)
                     for lo, hi in zip(bounds[:-1], bounds[1:])]:
            done.result()
    return out


def make_batches(
    *,
    features,  # [N, R, F] array, callable(indices[, out])->rows, or None
    existing: np.ndarray,
    existing_len: np.ndarray,
    target: Optional[np.ndarray] = None,
    target_len: Optional[np.ndarray] = None,
    image_id: Optional[np.ndarray] = None,
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    drop_remainder: bool = False,
    feat_shape: tuple[int, int] = (36, 2048),
    share: Optional[tuple[int, int]] = None,
    feature_out: Optional[Callable[[], np.ndarray]] = None,
) -> Iterator[Batch]:
    """Yield fixed-shape Batches over a split. The last partial batch is
    padded (rows repeated from index 0) with valid=False.

    ``share=(r, W)``: the r-th contiguous 1/W of every batch's rows, the
    batches and their order those of the whole split (data parallelism:
    each rank gathers only its own rows' features).

    ``feature_out``, with a callable ``features``: called once a batch,
    just before its gather, for the float32 [rows, R, F] array to gather
    the batch's features into (``features(idx, out=...)``); the batch's
    ``features`` is then that array."""
    r, w = share or (0, 1)
    if batch_size % w:
        raise ValueError(f"a batch of {batch_size} rows does not split "
                         f"evenly over W = {w} ranks")
    rows = slice(r * (batch_size // w), (r + 1) * (batch_size // w))
    n = existing.shape[0]
    order = np.arange(n)
    if shuffle:
        rng = np.random.default_rng(seed)
        rng.shuffle(order)
    if image_id is None:
        image_id = np.arange(n, dtype=np.int32)

    for lo in range(0, n, batch_size):
        idx = order[lo: lo + batch_size]
        b = idx.shape[0]
        if b < batch_size:
            if drop_remainder:
                return
            fill = np.zeros((batch_size - b,), dtype=idx.dtype)
            idx = np.concatenate([idx, fill])
        valid = np.zeros((batch_size,), dtype=bool)
        valid[:b] = True
        idx, valid = idx[rows], valid[rows]
        if callable(features) and feature_out is not None:
            feats = features(idx, out=feature_out())
        elif callable(features):
            feats = np.asarray(features(idx), dtype=np.float32)
        elif features is not None:
            feats = features[idx].astype(np.float32, copy=False)
        else:
            feats = np.zeros((len(idx), *feat_shape), dtype=np.float32)
        yield Batch(
            features=feats,
            existing=existing[idx],
            existing_len=existing_len[idx],
            target=None if target is None else target[idx],
            target_len=None if target_len is None else target_len[idx],
            valid=valid,
            image_id=image_id[idx].astype(np.int32, copy=False),
        )


def length_mask(lengths: np.ndarray, max_len: int) -> np.ndarray:
    """[B] lengths -> [B, max_len] bool mask (host-side)."""
    return np.arange(max_len)[None, :] < lengths[:, None]


def bucket_batches(
    batches: "Iterator[Batch]",
    boundaries: Sequence[int],
    *,
    agree: Optional[Callable[[list[int]], list[int]]] = None,
) -> Iterator[Batch]:
    """Length-bucketed batching: the rows of each incoming batch are
    re-emitted with their time axes cut to the smallest boundary >= the
    batch's longest real sequence (at most the original width). Rows,
    their order and the lengths are unchanged; only the padding tail goes,
    so masked computations give the same numbers.

    ``agree`` maps this process's longest lengths (existing, target) to
    the ones to cut at: data parallelism passes the maximum over the ranks,
    so every rank's share of a global batch is cut as the whole batch."""
    bounds = sorted(boundaries)
    agree = agree or (lambda needed: needed)

    def width(max_needed: int, cap: int) -> int:
        for b in bounds:
            if b >= max_needed:
                return min(b, cap)
        return cap

    for b in batches:
        ex_need, t_need = agree([
            int(b.existing_len.max()),
            int(b.target_len.max()) if b.target is not None else 0])
        ex_w = width(ex_need, b.existing.shape[1])
        if b.target is not None:
            t_w = width(t_need, b.target.shape[1])
            out_kw = dict(target=b.target[:, :t_w], target_len=b.target_len)
        else:
            out_kw = dict(target=None, target_len=None)
        yield Batch(
            features=b.features,
            existing=b.existing[:, :ex_w],
            existing_len=b.existing_len,
            valid=b.valid,
            image_id=b.image_id,
            **out_kw,
        )
