"""The one traffic generator: it reads a traffic file's parameters and makes
the work of a run from the seed.

Two kinds of traffic file:

* ``"kind": "offline"`` — a test split of ``images`` images decoded again
  and again in batches of ``batch_size`` (closed loop: the next pass
  starts when the last one ends). Existing captions have
  ``existing_words`` [lo, hi] words, every length equally often.
* ``"kind": "open_loop"`` — requests sent on a schedule whatever the
  server does (open loop), at ``rate_per_s`` on average. Gaps between
  arrivals are the quantiles of an exponential distribution (so every
  seed offers the same gaps, in its own order: Poisson arrivals with the
  count fixed); with ``burst_factor`` > 1 the clock runs that much faster
  for ``burst_duty`` of every ``burst_period_s`` and slower otherwise,
  the mean rate kept. Each request carries an existing caption of
  ``caption_words`` [lo, hi] words and names one of ``feature_pool``
  feature files.

A request is timed from when it was due, not from when it was sent, so a
late generator or a stalled server shows in the latency; the generator's
own lateness is reported beside it.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np


def arrivals(traffic: dict, seconds: float, rng: np.random.Generator
             ) -> np.ndarray:
    """Due times (seconds from the window's start) of the requests of a
    window of ``seconds``: ``round(rate * seconds)`` of them."""
    rate = float(traffic["rate_per_s"])
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)  # unit-mean quantiles
    rng.shuffle(gaps)
    # n arrivals in [0, seconds): the first at 0
    unit = (np.cumsum(gaps) - gaps) * (seconds / gaps.sum())
    factor = float(traffic.get("burst_factor", 1.0))
    if factor == 1.0:
        return unit
    period = float(traffic["burst_period_s"])
    duty = float(traffic["burst_duty"])
    # Intensity high during the duty share of each period, low otherwise,
    # with mean 1: the window's clock is mapped through its integral.
    low = 1.0 / (duty * factor + (1.0 - duty))
    high = factor * low
    grid = np.linspace(0.0, seconds, int(seconds / period * 200) + 2)
    phase = (grid % period) / period
    intensity = np.where(phase < duty, high, low)
    cum = np.concatenate([[0.0], np.cumsum(
        0.5 * (intensity[1:] + intensity[:-1]) * np.diff(grid))])
    cum *= seconds / cum[-1]
    return np.interp(unit, cum, grid)


def words_pattern(n: int, lo: int, hi: int, rng: np.random.Generator
                  ) -> np.ndarray:
    """n caption lengths covering lo..hi evenly (the same multiset for
    every seed), in the seed's order."""
    lengths = np.resize(np.arange(lo, hi + 1), n)
    rng.shuffle(lengths)
    return lengths


@dataclass
class Request:
    rid: int
    due: float  # seconds from the window's start
    words: list
    feature: int  # index into the feature pool


def make_requests(traffic: dict, seconds: float, rng: np.random.Generator,
                  vocab_words: list) -> list[Request]:
    due = arrivals(traffic, seconds, rng)
    lo, hi = traffic["caption_words"]
    lens = words_pattern(len(due), lo, hi, rng)
    pool = int(traffic["feature_pool"])
    feats = rng.integers(0, pool, len(due))
    words = np.asarray(vocab_words)
    out = []
    for i, (t, n, f) in enumerate(zip(due, lens, feats)):
        ids = rng.integers(0, len(words), int(n))
        out.append(Request(i, float(t), list(words[ids]), int(f)))
    return out


@dataclass
class OpenLoopRun:
    """What the client saw: when each request was due, sent and answered
    (host clock, seconds from the window's start; NaN for never) and what
    the answer said."""

    due: np.ndarray
    sent: np.ndarray
    received: np.ndarray
    answers: dict = field(default_factory=dict)  # rid -> response object
    order: list = field(default_factory=list)  # rids in answer order
    duplicates: int = 0
    strays: list = field(default_factory=list)  # lines with no known id
    ready: bool = False

    def lateness(self) -> np.ndarray:
        return self.sent - self.due

    def latencies(self) -> np.ndarray:
        """Received minus due; NaN where no answer came."""
        return self.received - self.due


def percentile(values: np.ndarray, q: float) -> float:
    """The q-th percentile (0-100) of ``values`` by the nearest-rank rule,
    where NaN (no answer) ranks above every number: +inf if the rank
    falls on one."""
    v = np.where(np.isnan(values), np.inf, values)
    v = np.sort(v)
    rank = max(1, int(np.ceil(q / 100.0 * len(v))))
    return float(v[rank - 1])


def run_open_loop(lines: list, due: np.ndarray, write_fd: int, read_file,
                  *, wait_s: float, clock=time.perf_counter) -> OpenLoopRun:
    """Send ``lines`` [i] (one JSON request each, ids 0..n-1) at
    ``due`` [i] seconds from now through ``write_fd`` and read the
    responses from ``read_file`` in another thread, until every request
    has its answer or ``wait_s`` after the last due time. Closes
    ``write_fd`` (end of input) before it returns."""
    n = len(lines)
    run = OpenLoopRun(due=np.asarray(due, float), sent=np.full(n, np.nan),
                      received=np.full(n, np.nan))
    done = threading.Event()
    t0 = clock() + 0.05

    def collect() -> None:
        left = n
        for raw in read_file:
            now = clock() - t0
            try:
                obj = json.loads(raw)
            except json.JSONDecodeError:
                run.strays.append(raw[:200])
                continue
            if obj.get("ready"):
                run.ready = True
                continue
            rid = obj.get("id")
            if not isinstance(rid, int) or not 0 <= rid < n:
                run.strays.append(raw[:200])
                continue
            if rid in run.answers:
                run.duplicates += 1
                continue
            run.answers[rid] = obj
            run.order.append(rid)
            run.received[rid] = now
            left -= 1
            if left == 0:
                done.set()
        done.set()

    reader = threading.Thread(target=collect, name="ckbench-collector",
                              daemon=True)
    reader.start()
    i = 0
    while i < n:
        now = clock() - t0
        if due[i] > now:
            time.sleep(min(due[i] - now, 0.005))
            continue
        j = i
        while j < n and due[j] <= now:
            j += 1
        payload = "".join(lines[i:j]).encode()
        _write_all(write_fd, payload)
        run.sent[i:j] = clock() - t0
        i = j
    done.wait(timeout=max(0.0, float(due[-1]) + wait_s - (clock() - t0)))
    os.close(write_fd)
    reader.join(timeout=wait_s + 30)
    return run


def _write_all(fd: int, payload: bytes) -> None:
    view = memoryview(payload)
    while view:
        view = view[os.write(fd, view):]
