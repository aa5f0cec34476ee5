"""Preemption-safe training: catch SIGTERM, checkpoint, exit cleanly
(``captionkit.utils.preemption``).

A scheduler that reclaims a machine sends SIGTERM and waits a short
grace window. The epoch drivers (``train/loop.py``) poll a
``PreemptionGuard`` between steps: on a caught signal they drain the
pending metrics, save a checkpoint at the exact step, mark the report and
return; ``--resume`` then continues the same trajectory.

On a mesh (``parallel/mesh.py``) the loops poll through ``stop_poll``:
the flag is agreed by every rank at each poll, so a signal caught on any
rank stops every rank at the same step.

Usage (``cli train-xe`` installs it):

    with PreemptionGuard() as guard:
        run_xe_training(..., preemption=guard)
"""

from __future__ import annotations

import logging
import signal
import threading
from types import FrameType
from typing import Callable, Optional

log = logging.getLogger(__name__)


class PreemptionGuard:
    """Latches termination signals into a pollable flag.

    Handlers are installed on __enter__ and restored on __exit__, so the
    guard only intercepts signals for the duration of the training run.
    Install from the main thread (a CPython signal-module requirement).
    A second signal while the first is still being honored re-raises the
    default behavior, so a stuck save can still be killed.
    """

    def __init__(self, signals: tuple[int, ...] = (signal.SIGTERM,)):
        self._signals = signals
        self._prev: dict[int, object] = {}
        self._event = threading.Event()

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def request(self, signum: Optional[int] = None) -> None:
        """Programmatic trigger (also the signal handler body)."""
        if not self._event.is_set():
            log.warning(
                "preemption requested (%s): will checkpoint and exit at "
                "the next dispatch boundary",
                signal.Signals(signum).name if signum else "manual",
            )
        self._event.set()

    def _handler(self, signum: int, frame: Optional[FrameType]) -> None:
        if self._event.is_set():
            # Second signal: restore default disposition and re-deliver,
            # so an operator can still force-kill a wedged save.
            signal.signal(signum, signal.SIG_DFL)
            signal.raise_signal(signum)
            return
        self.request(signum)

    def __enter__(self) -> "PreemptionGuard":
        for s in self._signals:
            self._prev[s] = signal.getsignal(s)
            signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)  # type: ignore[arg-type]
        self._prev.clear()
        return None


def stop_poll(guard: Optional[PreemptionGuard], mesh=None
              ) -> Callable[[], bool]:
    """() -> whether to stop now. With ``mesh`` every call is one host
    all-reduce of the flag (every rank must poll alike), so all ranks see
    True once any rank caught a signal."""
    if guard is None:
        return lambda: False
    if mesh is None:
        return lambda: guard.requested
    from captionkit_torch.parallel.mesh import host_max

    return lambda: host_max(mesh, [guard.requested])[0] > 0
