"""Checkpointing (``captionkit.train.checkpoint``, without Orbax).

``CheckpointManager`` keeps the reference's layout: a rotation of the
``keep`` newest checkpoints under ``recent/<step>/``, a ``best/`` snapshot
that rotation never removes, and ``best.json`` with the best step and
metric. A checkpoint is one ``torch.save`` file (``state.pt``) of the
parameters and the optimizer state by name, the step, the dropout
generator's seed and the best metric so far; ``restore`` gives back a
``TrainState`` that continues the exact trajectory. The reference's
checkpoints are Orbax directories and the two formats do not read each
other; the flat ``.npz`` of ``save_params_npz``/``load_params_npz``
(``captionkit_torch.params``) is the interchange format both packages
read and write.

With a mesh (``parallel/mesh.py``) only rank 0 writes, and every save and
every restore passes a barrier: no rank reads a checkpoint before it is
whole, nor returns from a save before rank 0 has written it, and every
rank restores the same state.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import torch

from captionkit_torch.parallel.mesh import barrier, host_max
from captionkit_torch.params import (  # noqa: F401  (re-exported)
    load_params_npz,
    named_tensors,
    params_from_tensors,
    save_params_npz,
)
from captionkit_torch.train.state import OptState, TrainState

_FILE = "state.pt"


def _state_dict(state: TrainState, best: Optional[float],
                extra: Optional[dict]) -> dict:
    def detach(d):
        return None if d is None else {n: t.detach() for n, t in d.items()}

    st = state.opt_state
    return {
        "step": int(state.step),
        "rng_seed": int(state.rng_seed),
        "params": detach(named_tensors(state.params)),
        "opt_state": {"count": int(st.count), "mu": detach(st.mu),
                      "nu": detach(st.nu), "ema": detach(st.ema)},
        "best_metric": best,
        "extra": dict(extra or {}),
    }


def _from_state_dict(sd: dict, template: TrainState) -> TrainState:
    like = named_tensors(template.params)
    missing = sorted(set(like) - set(sd["params"]))
    if missing:
        raise KeyError(f"checkpoint lacks {missing}")
    params = params_from_tensors(
        {n: sd["params"][n].to(t.device, t.dtype).requires_grad_(True)
         for n, t in like.items()}, template.params)
    dev = next(iter(like.values())).device

    def move(d):
        return None if d is None else {n: t.to(dev) for n, t in d.items()}

    o = sd["opt_state"]
    return TrainState(
        params=params,
        opt_state=OptState(count=int(o["count"]), mu=move(o["mu"]) or {},
                           nu=move(o["nu"]) or {}, ema=move(o["ema"])),
        step=int(sd["step"]), rng_seed=int(sd["rng_seed"]))


def _write(sd: dict, directory: str) -> None:
    """Write ``sd`` into ``directory`` through a temporary sibling, so a
    directory that exists holds a whole checkpoint."""
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    torch.save(sd, os.path.join(tmp, _FILE))
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.rename(tmp, directory)


def _read(directory: str, template: TrainState) -> TrainState:
    sd = torch.load(os.path.join(directory, _FILE), map_location="cpu",
                    weights_only=True)
    return _from_state_dict(sd, template)


class CheckpointManager:
    """Rotating step checkpoints plus a best-metric snapshot."""

    def __init__(self, directory: str, *, keep: int = 3, mesh=None):
        self.directory = os.path.abspath(directory)
        self.keep = int(keep)
        self.mesh = mesh
        self._recent = os.path.join(self.directory, "recent")
        self._best_dir = os.path.join(self.directory, "best")
        self._meta_path = os.path.join(self.directory, "best.json")
        if self._writes:
            os.makedirs(self._recent, exist_ok=True)
        self._barrier()

    @property
    def _writes(self) -> bool:
        return self.mesh is None or self.mesh.is_main

    def _barrier(self) -> None:
        if self.mesh is not None:
            barrier(self.mesh)

    def save(self, state: TrainState, *, metric: Optional[float] = None,
             extra: Optional[dict[str, Any]] = None) -> bool:
        """Save at ``state.step`` and rotate; with ``metric``, track the
        best. Returns True when this save is the new best (on every rank
        of a mesh; rank 0 writes)."""
        step = int(state.step)
        is_best = False
        if self._writes:
            best = self.best_metric()
            is_best = metric is not None and (best is None or metric > best)
            self._save(state, step, best, is_best, metric, extra)
        if self.mesh is not None:
            # Rank 0's verdict, after it has written (a barrier as well):
            # no other rank reads best.json while rank 0 may rewrite it.
            is_best = bool(host_max(self.mesh, [int(is_best)])[0])
        return is_best

    def _save(self, state, step, best, is_best, metric, extra) -> None:
        sd = _state_dict(state, metric if is_best else best, extra)
        _write(sd, os.path.join(self._recent, str(step)))
        for old in self.all_steps()[:-self.keep] if self.keep > 0 else ():
            shutil.rmtree(os.path.join(self._recent, str(old)))
        if is_best:
            _write(sd, self._best_dir)
            payload = {"step": step, "metric": float(metric)}
            payload.update(extra or {})
            with open(self._meta_path, "w") as f:
                json.dump(payload, f)

    def restore(self, template: TrainState, *,
                step: Optional[int] = None) -> TrainState:
        """The checkpoint at ``step`` (default the latest), on the devices
        and in the structure of ``template``."""
        self._barrier()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return _read(os.path.join(self._recent, str(step)), template)

    def restore_best(self, template: TrainState) -> TrainState:
        """The best-metric snapshot (never rotated away)."""
        self._barrier()
        if not os.path.exists(self._best_dir):
            raise FileNotFoundError(f"no best checkpoint in {self.directory}")
        return _read(self._best_dir, template)

    def all_steps(self) -> list[int]:
        if not os.path.isdir(self._recent):
            return []
        return sorted(int(d) for d in os.listdir(self._recent)
                      if d.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_metric(self) -> Optional[float]:
        if not os.path.exists(self._meta_path):
            return None
        with open(self._meta_path) as f:
            return float(json.load(f)["metric"])

    def best_step(self) -> Optional[int]:
        if not os.path.exists(self._meta_path):
            return None
        with open(self._meta_path) as f:
            return int(json.load(f)["step"])

    def close(self) -> None:
        """Nothing to flush: every save is written before it returns."""
