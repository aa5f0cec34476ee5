"""The port's spans and counters (``captionkit.utils.profiling``).

* ``trace(dir)`` — context manager around any region: ``torch.profiler``
  with the CPU and (when there is a card) CUDA activities, written as a
  Chrome/Perfetto trace (``*.pt.trace.json``) into ``dir`` (open it in
  ui.perfetto.dev or chrome://tracing). A no-op for None.
* ``annotate(name)`` — a named host span. Outside a profiler session it
  does nothing but ask whether one runs. Inside one it is a
  ``torch.profiler.record_function`` (an event of the session's trace, on
  the device timeline's clock) and, when it ends, an entry in this
  module's store: one more span of its name, its duration
  (``time.perf_counter_ns``) and the time its child spans cover (a
  per-thread stack).
* ``count(name, n=1)`` — adds ``n`` to a counter, under the same gate.
* ``count_device(name, t)`` — adds a device scalar ``t`` to a counter,
  under the same gate, without reading it: the sums stay on the device
  until ``flush_device()`` reads them all at once (the split decode does
  at its read-back of a batch's tokens) and adds them to the store.
* ``summary()`` — per span name its count, total and self time in ns
  (self: the duration less its child spans), and every counter's total;
  ``reset()`` empties the store.

Whether a span is recorded is decided when it is entered: a span entered
inside a session is stored when it ends, even after the session closed.
Names starting with ``ckbench.`` belong to the benchmark and are refused.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Optional

import torch

#: True while a ``torch.profiler`` (or autograd profiler) session runs.
enabled = torch._C._autograd._profiler_enabled

_OFF = contextlib.nullcontext()
_RESERVED = "ckbench."

_spans: dict = {}  # name -> [count, total_ns, self_ns]
_counters: dict = {}
_device_counts: dict = {}  # name -> running device sum, not yet read
_lock = threading.Lock()
_local = threading.local()


def _check(name: str) -> None:
    if name.startswith(_RESERVED):
        raise ValueError(f"span and counter names may not start with "
                         f"{_RESERVED!r}: {name!r}")


def _add(name: str, dur_ns: int, child_ns: int = 0) -> None:
    """Store one ended span of ``name``."""
    with _lock:
        agg = _spans.setdefault(name, [0, 0, 0])
        agg[0] += 1
        agg[1] += dur_ns
        agg[2] += dur_ns - child_ns


class _Span:
    __slots__ = ("name", "rf", "start", "child_ns", "parent")

    def __init__(self, name: str):
        _check(name)
        self.name, self.child_ns = name, 0

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.start
        self.rf.__exit__(*exc)
        _local.stack.pop()
        if self.parent is not None:
            self.parent.child_ns += dur
        _add(self.name, dur, self.child_ns)
        return False


def annotate(name: str):
    """A named host span, recorded only inside a profiler session."""
    if not enabled():
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``, only inside a profiler session."""
    if not enabled():
        return
    _check(name)
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(n)


def count_device(name: str, t: torch.Tensor) -> None:
    """Add the device scalar ``t`` to counter ``name``, only inside a
    profiler session; read by ``flush_device``."""
    if not enabled():
        return
    _check(name)
    t = t.detach().to(torch.int64)
    with _lock:
        prev = _device_counts.get(name)
        _device_counts[name] = t if prev is None else prev + t


def flush_device() -> None:
    """Read the device counters' sums (one read) into the store."""
    with _lock:
        if not _device_counts:
            return
        names = list(_device_counts)
        sums = torch.stack([_device_counts.pop(n) for n in names]).tolist()
        for name, n in zip(names, sums):
            _counters[name] = _counters.get(name, 0) + int(n)


def summary() -> dict:
    """{"spans": {name: {"count", "total_ns", "self_ns"}},
    "counters": {name: total}} of what the store holds."""
    with _lock:
        return {"spans": {name: {"count": c, "total_ns": t, "self_ns": s}
                          for name, (c, t, s) in _spans.items()},
                "counters": dict(_counters)}


def reset() -> None:
    with _lock:
        _spans.clear()
        _counters.clear()
        _device_counts.clear()


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
