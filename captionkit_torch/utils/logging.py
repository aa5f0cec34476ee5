"""Structured run logging (``captionkit.utils.logging``, JSONL only).

Every call of ``MetricsLogger.log`` appends one JSON record, ``{"step",
"time", <scalars>}``, to ``<run_dir>/metrics.jsonl``. The reference also
mirrors the scalars to TensorBoard when TensorFlow is importable; the
port writes the JSONL file only. On a mesh (``parallel/mesh.py``) only
rank 0 writes: the other ranks' loggers open nothing and drop every
record (the loops log the same global numbers on every rank).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsLogger:
    """Append-only JSONL scalar log."""

    def __init__(self, run_dir: str, *, mesh=None):
        self.run_dir = run_dir
        self.path = os.path.join(run_dir, "metrics.jsonl")
        self._fh = None
        if mesh is None or mesh.is_main:
            os.makedirs(run_dir, exist_ok=True)
            self._fh = open(self.path, "a")

    def log(self, step: int, scalars: dict[str, float],
            *, wall: Optional[float] = None) -> None:
        if self._fh is None:
            return
        rec = {"step": int(step), "time": wall or time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
