"""Tracing and throughput counters (``captionkit.utils.profiling``).

* ``trace(dir)`` — context manager around any region: ``torch.profiler``
  with the CPU and (when there is a card) CUDA activities, written as a
  Chrome/Perfetto trace (``*.pt.trace.json``) into ``dir`` (open it in
  ui.perfetto.dev or chrome://tracing). A no-op for None.
* ``annotate(name)`` — a named host range, ``torch.profiler.
  record_function`` plus an NVTX range on the card, so host phases line
  up with the device's kernels in the trace.
* ``ThroughputCounter`` — captions/s or tokens/s after a warm-up window.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the enclosed region into ``log_dir`` (no-op when None);
    yields the ``torch.profiler.profile`` (None when off)."""
    if not log_dir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"captionkit.{os.getpid()}.{time.time_ns()}.pt.trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named host range visible in the trace (and to NVTX on the card)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@dataclass
class ThroughputCounter:
    """Steady-state items/sec with a warm-up exclusion window."""

    warmup: int = 1  # number of initial update() calls excluded
    _items: int = 0
    _calls: int = 0
    _t0: float = field(default_factory=time.perf_counter)

    def update(self, n_items: int) -> None:
        self._calls += 1
        if self._calls <= self.warmup:
            self._t0 = time.perf_counter()
            return
        self._items += n_items

    @property
    def items_per_sec(self) -> float:
        if self._items == 0:
            return 0.0
        dt = time.perf_counter() - self._t0
        return self._items / dt if dt > 0 else 0.0

    @property
    def items(self) -> int:
        return self._items
