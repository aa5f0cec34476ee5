"""Structured run logging (``captionkit.utils.logging``, JSONL only).

Every call of ``MetricsLogger.log`` appends one JSON record, ``{"step",
"time", <scalars>}``, to ``<run_dir>/metrics.jsonl``. The reference also
mirrors the scalars to TensorBoard when TensorFlow is importable; the
port writes the JSONL file only. On a mesh (``parallel/mesh.py``) only
rank 0 writes: the other ranks' loggers open nothing and drop every
record (the loops log the same global numbers on every rank).

``--debug-nans`` (``enable_nan_debugging``): the reference turns on
``jax_debug_nans``, which checks the floating-point outputs of every
jitted call and of every eager primitive, and raises
``FloatingPointError`` on a NaN. The port has no jit, so its counterparts
of the reference's jitted calls (the XE step, the k-step pack, the eval
loss, the SCST rollout and update) pass their outputs to ``check_nans``,
and so does the one eager op that the reference checks before a decode,
the ensemble's ``stack_params``. Integer and bool outputs (the decodes'
tokens) and values inside a call are not checked, as in the reference;
``-inf`` never raises. The flag is process-global, as JAX's is.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Iterator, Optional

import torch

_debug_nans = False


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


def enable_nan_debugging() -> None:
    """Make every guarded call raise ``FloatingPointError`` when one of its
    floating-point outputs holds a NaN, for the rest of the process."""
    global _debug_nans
    _debug_nans = True


def nan_debugging_enabled() -> bool:
    return _debug_nans


@contextlib.contextmanager
def debug_nans(enabled: bool = True) -> Iterator[None]:
    """The flag set to ``enabled`` inside the block, restored after it."""
    global _debug_nans
    before = _debug_nans
    _debug_nans = enabled
    try:
        yield
    finally:
        _debug_nans = before


def _float_leaves(obj: Any, path: str, out: list) -> None:
    if isinstance(obj, torch.Tensor):
        if obj.is_floating_point():
            out.append((path, obj))
        return
    if isinstance(obj, dict):
        items = obj.items()
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        items = zip(obj._fields, obj)
    elif isinstance(obj, (list, tuple)):
        items = enumerate(obj)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        # Fields left out of equality (the parameters' packed-weight
        # caches) are derived from the others, not outputs of their own.
        items = ((f.name, getattr(obj, f.name))
                 for f in dataclasses.fields(obj) if f.compare)
    else:
        return
    for key, value in items:
        _float_leaves(value, f"{path}/{key}" if path else str(key), out)


def check_nans(call: str, outputs: Any) -> None:
    """Raise ``FloatingPointError`` naming ``call`` and the path of the
    first floating-point leaf of ``outputs`` (tensors in dicts, tuples,
    lists and dataclasses: a ``TrainState``, parameter objects) that holds
    a NaN. Each leaf is reduced on its device and the flags are read back
    in one host read per device. With the flag off it returns before it
    touches a tensor."""
    if not _debug_nans:
        return
    leaves: list = []
    _float_leaves(outputs, "", leaves)
    by_device: dict = {}
    for i, (_, t) in enumerate(leaves):
        by_device.setdefault(t.device, []).append(i)
    bad = []
    for idx in by_device.values():
        flags = torch.stack([torch.isnan(leaves[i][1]).any() for i in idx])
        bad.extend(i for i, f in zip(idx, flags.tolist()) if f)
    if bad:
        raise FloatingPointError(
            f"invalid value (nan) encountered in {call}: "
            f"{leaves[min(bad)][0]}")
