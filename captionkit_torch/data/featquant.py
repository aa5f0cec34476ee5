"""Host->device feed of the region features (``decode.feed_dtype``;
``captionkit.data.featquant``).

"float32" ships the features as they are; "bfloat16" casts them on the
host, which halves the transfer (the model stores its visual context in
bfloat16 anyway); "int8" quantizes each region on the host, symmetric and
zero-point-free: scale = amax / 127, q = clip(rint(x / scale), -127, 127),
all-zero regions scale 1. A [36, 2048] fp32 region block (288 KiB) ships
as 72 KiB of int8 and 36 fp32 scales. The decode function moves the staged
feed to the device (``feed_to_device``) and, for "int8", dequantizes it
there (``dequantize_for_feed``): one fp32 multiply and one cast to the
bfloat16 grid the bfloat16 feed lands on, so the model sees the same kind
of input. Element-wise error: |x - deq(q)| <= scale / 2 plus the bf16
rounding, under 0.8% of the region's largest magnitude.

A tensor in pinned host memory goes to a CUDA device without blocking:
``feed_to_device`` enqueues its copy on the current stream and returns,
so the kernels that read it follow the copy in stream order. A pageable
tensor keeps the blocking copy. ``pinned_feed_ring`` keeps, once per
process for a device and a shape, a ring of pinned float32 slots that
``decode_split`` gathers each batch's features into; each slot has a CUDA
event, recorded by ``feed_to_device`` right after the copy out of the
slot, and ``PinnedFeedRing.acquire`` waits on it before the slot is
written again.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from captionkit_torch.utils import profiling

#: feed_dtype values the decode and serving paths accept.
FEED_DTYPES = ("float32", "bfloat16", "int8")
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8}

Staged = Union[None, torch.Tensor, tuple[torch.Tensor, torch.Tensor]]


def feed_torch_dtype(feed_dtype: str) -> torch.dtype:
    """The torch dtype that crosses the transfer for a ``feed_dtype``
    (int8 for "int8": the quantized values); raises for unknown names."""
    if feed_dtype not in _TORCH_DTYPES:
        raise ValueError("feed_dtype must be 'float32', 'bfloat16' or "
                         f"'int8', got {feed_dtype!r}")
    return _TORCH_DTYPES[feed_dtype]


def quantize_features(feats: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side: [..., R, F] float features -> (q int8 [..., R, F],
    scale float32 [..., R]). Symmetric per region; all-zero regions get
    scale 1.0 (q is then all zero, dequantization exact)."""
    feats = np.asarray(feats, np.float32)
    amax = np.max(np.abs(feats), axis=-1)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(feats / scale[..., None]), -127, 127)
    return q.astype(np.int8), scale


def dequantize_features(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Device-side: (q int8, scale fp32 [..., R]) -> bfloat16 features:
    an fp32 multiply, then one cast to bf16."""
    return (q.float() * scale[..., None]).to(torch.bfloat16)


def quantize_for_feed(feats: Optional[np.ndarray], feed_dtype: str
                      ) -> Staged:
    """Host-side staging: CPU tensors in the feed's form, the (q, scale)
    pair for "int8", else one tensor in the feed dtype. None passes
    through (text-only batches)."""
    dt = feed_torch_dtype(feed_dtype)
    if feats is None:
        return None
    if feed_dtype == "int8":
        q, scale = quantize_features(feats)
        return torch.from_numpy(q), torch.from_numpy(scale)
    return torch.from_numpy(np.ascontiguousarray(feats, np.float32)).to(dt)


class PinnedFeedRing:
    """Two pinned float32 host slots of one shape, handed out in turn,
    each with the CUDA event of its last copy to the card."""

    def __init__(self, shape: tuple[int, ...]):
        self.slots = [torch.empty(shape, dtype=torch.float32,
                                  pin_memory=True) for _ in range(2)]
        self.events = [torch.cuda.Event() for _ in self.slots]
        for slot, event in zip(self.slots, self.events):
            _SLOT_EVENTS[slot.data_ptr()] = event
        self._next = 0

    def acquire(self) -> np.ndarray:
        """The next slot, as a writable numpy view, once the copy last
        made out of it (``feed_to_device``) has landed."""
        k = self._next
        self._next = (k + 1) % len(self.slots)
        self.events[k].synchronize()
        return self.slots[k].numpy()


# Each slot's event, by the address of its memory; and the rings, by
# (device, shape). Both live as long as the process: a ring's pinned
# allocation costs more than a copy, so it is made once.
_SLOT_EVENTS: dict[int, torch.cuda.Event] = {}
_RINGS: dict[tuple, PinnedFeedRing] = {}


def pinned_feed_ring(device: "str | torch.device",
                     shape: tuple[int, ...]) -> PinnedFeedRing:
    """The process's ring of pinned float32 slots of ``shape`` for the
    CUDA ``device``: made at the first call, the same ring after. Two
    slots serve ``decode_split``'s two batches in flight: the slot of
    batch k + 2 is that of batch k, whose copy has long landed."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    key = (dev, tuple(shape))
    if key not in _RINGS:
        _RINGS[key] = PinnedFeedRing(tuple(shape))
    return _RINGS[key]


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    if device.type != "cuda" or not t.is_pinned():
        return t.to(device)
    out = t.to(device, non_blocking=True)
    event = _SLOT_EVENTS.get(t.data_ptr())
    if event is not None:
        event.record(torch.cuda.current_stream(device))
    return out


def feed_to_device(staged: Staged, device: "str | torch.device") -> Staged:
    """Move a staged feed (tensor or (q, scale) pair) to ``device``. To a
    CUDA device a tensor in pinned memory is copied without blocking, and
    the event of its ring slot, if it is one, is recorded right after the
    copy; a pageable one is copied as before, blocking. Inside a profiler
    session the bytes of each tensor are counted as ``feed_bytes_pinned``
    or ``feed_bytes_pageable`` (``utils/profiling``)."""
    if staged is None:
        return None
    device = torch.device(device)
    tensors = staged if isinstance(staged, tuple) else (staged,)
    if profiling.enabled():
        for t in tensors:
            profiling.count("feed_bytes_pinned" if t.is_pinned()
                            else "feed_bytes_pageable", t.nbytes)
    moved = tuple(_to_device(t, device) for t in tensors)
    return moved if isinstance(staged, tuple) else moved[0]


def dequantize_for_feed(features: Staged, feed_dtype: str
                        ) -> Optional[torch.Tensor]:
    """Undo ``quantize_for_feed`` on the device: for "int8" the (q, scale)
    pair becomes bf16 features; other feeds pass through (the model's
    ``encode`` does its own casts)."""
    if features is None or feed_dtype != "int8":
        return features
    if not (isinstance(features, tuple) and len(features) == 2):
        raise TypeError("feed_dtype='int8' expects the (q, scale) pair of "
                        "quantize_for_feed")
    q, scale = features
    return dequantize_features(q, scale)
