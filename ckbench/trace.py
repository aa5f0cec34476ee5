"""One ``torch.profiler`` session over part of a run, read back from its
Chrome trace.

The benchmark marks its own host spans with ``record_function``
("ckbench.batch" around each batch it hands the program, "ckbench.call"
ranges around the port's kernel wrappers). A device activity belongs to a
span when the host call that launched it (a CUDA runtime or driver event
with the same correlation id) ran on the span's thread inside the span.
So a span's device time is counted by what it launched, not by kernel
names.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def union_s(intervals) -> float:
    """Seconds covered by (start_us, end_us) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total * 1e-6


@dataclass
class Span:
    name: str
    start: float  # us, trace clock
    end: float
    device: list = field(default_factory=list)  # (start, end, cat, name)

    def device_s(self, cats=DEVICE_CATS) -> float:
        return sum(e - s for s, e, c, _ in self.device if c in cats) * 1e-6

    def device_span_s(self, cats=("kernel",)) -> float:
        """Seconds the span's activities of ``cats`` covered on the
        device (overlapping launches counted once)."""
        return union_s([(s, e) for s, e, c, _ in self.device if c in cats])


@dataclass
class TraceSummary:
    window_s: float  # host clock, profiler start to stop
    busy_s: float  # device activity, overlaps counted once
    spans: dict  # name -> [Span] in start order
    device_ops: list  # [[name, seconds]] most time first
    idle_gaps: list  # [[what the host was doing, seconds]] most first

    def named(self, prefix: str) -> list:
        return [s for n, ss in self.spans.items() if n.startswith(prefix)
                for s in ss]


def read_trace(path: str, window_s: float, top: int = 10) -> TraceSummary:
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    device, launches, host, marks = [], {}, [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts, dur = float(ev.get("ts", 0)), float(ev.get("dur", 0))
        args = ev.get("args") or {}
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, cat, ev.get("name", ""),
                           args.get("correlation")))
            continue
        tid = ev.get("tid")
        if cat in LAUNCH_CATS and "correlation" in args:
            launches.setdefault(tid, []).append((ts, args["correlation"]))
        if cat == "user_annotation" and ev.get("name", "").startswith(
                "ckbench."):
            marks.append((ev["name"], tid, ts, ts + dur))
        if cat in HOST_CATS:
            host.append((ts, ts + dur, ev.get("name", "")))
    by_corr = defaultdict(list)
    for s, e, cat, name, corr in device:
        if corr is not None:
            by_corr[corr].append((s, e, cat, name))
    for tid in launches:
        launches[tid].sort()
    spans = defaultdict(list)
    for name, tid, s, e in sorted(marks, key=lambda m: m[2]):
        span = Span(name, s, e)
        rows = launches.get(tid, [])
        lo = bisect.bisect_left(rows, (s, -1))
        hi = bisect.bisect_right(rows, (e, float("inf")))
        for _, corr in rows[lo:hi]:
            span.device.extend(by_corr.get(corr, ()))
        spans[name].append(span)
    intervals = [(s, e) for s, e, _, _, _ in device]
    by_name = defaultdict(float)
    for s, e, _, name, _ in device:
        by_name[name[:120]] += (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return TraceSummary(
        window_s=window_s, busy_s=union_s(intervals), spans=dict(spans),
        device_ops=[[n, s] for n, s in ops],
        idle_gaps=_idle_gaps(intervals, host, top))


def _idle_gaps(intervals, host, top):
    """Idle stretches of the device between its first and last activity,
    summed by the innermost host event running at each one's middle."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    host = sorted(host)
    starts = [h[0] for h in host]
    by_what = defaultdict(float)
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = 0.5 * (a + b)
        best = None
        i = bisect.bisect_right(starts, mid)
        for s, e, name in host[max(0, i - 400):i]:
            if e >= mid and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        what = best[2][:120] if best else "host Python outside any torch op"
        by_what[what] += (b - a) * 1e-6
    return [[n, s] for n, s in sorted(by_what.items(),
                                      key=lambda kv: -kv[1])[:top]]


class Tracer:
    """Start and stop one profiler session; ``summary`` after ``stop``."""

    def __init__(self):
        self.prof = None
        self.active = False
        self.summary = None
        self._t0 = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        self.active = True

    def stop(self) -> None:
        import torch

        if not self.active:
            return
        torch.cuda.synchronize()
        window = time.perf_counter() - self._t0
        self.active = False
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            self.summary = read_trace(path, window)
        finally:
            os.remove(path)
        self.prof = None
