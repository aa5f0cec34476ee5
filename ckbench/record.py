"""What a run measured, handed to every metric reader."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Record:
    workload: str
    arch: str
    model: dict  # the configuration's model fields as run
    decode: dict  # its decode fields as run (batch size from the traffic)
    traffic: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    # captions completed in the window, host seconds of each
    # batch's decode call (the benchmark's span around it)
    captions: int = 0
    batch_call_s: list = field(default_factory=list)
    # the traced part of the run (--trace 1): the profiler's summary, the
    # batches and captions whose calls lie inside it
    trace: object = None
    trace_batches: int = 0
    trace_captions: int = 0
