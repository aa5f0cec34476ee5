"""Structured run logging (``captionkit.utils.logging``, JSONL only).

Every call of ``MetricsLogger.log`` appends one JSON record, ``{"step",
"time", <scalars>}``, to ``<run_dir>/metrics.jsonl``. The reference also
mirrors the scalars to TensorBoard when TensorFlow is importable; the
port writes the JSONL file only.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsLogger:
    """Append-only JSONL scalar log."""

    def __init__(self, run_dir: str):
        os.makedirs(run_dir, exist_ok=True)
        self.run_dir = run_dir
        self.path = os.path.join(run_dir, "metrics.jsonl")
        self._fh = open(self.path, "a")

    def log(self, step: int, scalars: dict[str, float],
            *, wall: Optional[float] = None) -> None:
        rec = {"step": int(step), "time": wall or time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()
