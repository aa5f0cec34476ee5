"""Host-to-device prefetch (``captionkit.data.prefetch``).

``prefetch_to_device`` keeps ``size`` batches in flight on the device:
the copy of batch k+1 is queued while batch k computes. On a CUDA device

* each batch's host arrays are packed into a pinned staging buffer, one
  of a ring of ``size + 1`` reused across batches and grown to the largest
  batch seen (allocating pinned memory every batch would cost more than
  the copy);
* the copies run on a side stream, and an event marks the end of each
  batch's copies;
* a batch is handed out only after the consumer's stream has been told to
  wait on its event, and each of its tensors is marked with
  ``record_stream`` for the consumer's stream, so the caching allocator
  does not reuse its memory while the consumer's kernels may still read
  it;
* a staging buffer is written again only after its previous copy has
  completed (its event is waited on first).

On the CPU the batches come back as tensors, in order. A batch is a dict
of arrays (None values pass through), a bare array, or a tuple whose
dicts are moved and whose other items pass through unchanged (the XE
loop's tagged packs, the SCST loop's (batch, references)).
"""

from __future__ import annotations

import collections
from typing import Any, Iterable, Iterator, Optional

import numpy as np
import torch

from captionkit_torch.device import resolve_device

# Byte alignment of each array inside a staging buffer.
_ALIGN = 256
_END = object()


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def _map_batch(batch: Any, fn) -> Any:
    if isinstance(batch, dict):
        return {k: None if v is None else fn(v) for k, v in batch.items()}
    if isinstance(batch, tuple):
        return tuple(_map_batch(x, fn) if isinstance(x, dict) else x
                     for x in batch)
    return fn(batch)


def _leaves(batch: Any) -> list:
    out: list = []
    _map_batch(batch, out.append)
    return out


class _PinnedStager:
    """The CUDA side of ``prefetch_to_device``: a ring of pinned staging
    buffers, a side stream for the copies and an event per copy."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device=device)
        self.buffers: list[Optional[torch.Tensor]] = [None] * slots
        self.events: list[Optional[torch.cuda.Event]] = [None] * slots
        self.next = 0

    def put(self, batch: Any) -> tuple[Any, torch.cuda.Event]:
        host = _map_batch(batch, lambda x: _as_tensor(x).contiguous())
        sizes = [t.numel() * t.element_size() for t in _leaves(host)]
        need = sum(-(-n // _ALIGN) * _ALIGN for n in sizes)
        slot = self.next
        self.next = (slot + 1) % len(self.buffers)
        if self.events[slot] is not None:
            self.events[slot].synchronize()  # its last copy has landed
        buf = self.buffers[slot]
        if buf is None or buf.numel() < need:
            buf = torch.empty((need,), dtype=torch.uint8, pin_memory=True)
            self.buffers[slot] = buf
        offset = 0

        def stage(t: torch.Tensor) -> torch.Tensor:
            nonlocal offset
            n = t.numel() * t.element_size()
            view = buf[offset:offset + n].view(t.dtype).view(t.shape)
            view.copy_(t)
            offset += -(-n // _ALIGN) * _ALIGN
            return view

        pinned = _map_batch(host, stage)
        with torch.cuda.stream(self.stream):
            out = _map_batch(pinned, lambda t: t.to(self.device,
                                                    non_blocking=True))
            event = torch.cuda.Event()
            event.record(self.stream)
        self.events[slot] = event
        return out, event

    def hand_out(self, staged: tuple[Any, torch.cuda.Event]) -> Any:
        out, event = staged
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(event)
        for t in _leaves(out):
            t.record_stream(consumer)
        return out


class _HostStager:
    """The CPU side: the batch as tensors."""

    @staticmethod
    def put(batch: Any) -> Any:
        return _map_batch(batch, _as_tensor)

    @staticmethod
    def hand_out(staged: Any) -> Any:
        return staged


def prefetch_to_device(
    batches: Iterable[Any],
    *,
    size: int = 2,
    device: "str | torch.device" = "cuda",
    mesh: Optional[Any] = None,
) -> Iterator[Any]:
    """Yield the batches on ``device`` (the card unless the caller names
    the CPU), in order, with ``size`` copies in flight. ``mesh`` must be
    None: data-parallel placement is not ported."""
    if size < 1:
        raise ValueError("prefetch size must be >= 1")
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel placement is not ported yet: pass mesh=None")
    dev = resolve_device(device)
    stager = (_PinnedStager(dev, size + 1) if dev.type == "cuda"
              else _HostStager())
    queue: collections.deque = collections.deque()
    it = iter(batches)
    for batch in it:
        queue.append(stager.put(batch))
        if len(queue) == size:
            break
    while queue:
        staged = queue.popleft()
        nxt = next(it, _END)
        if nxt is not _END:
            queue.append(stager.put(nxt))
        yield stager.hand_out(staged)
