#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s device, build and train phases alone, on one
card: the quick check of the XE training path (``cli train-xe`` at
``xe_train``'s paper width, resume, export, the gradient check, times).

    python3 examples/torch_train_phase.py

Prints the phases' JSON lines (the train phase's as ``chip_smoke.py``
prints it) and the seconds the whole run took.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main() -> int:
    t0 = time.time()
    info = chip_smoke.phase_device()
    chip_smoke.phase_build()
    from captionkit_torch.kernels import WRAPPERS

    chip_smoke.phase_train(WRAPPERS, info["nvidia_smi"])
    print(f"seconds {time.time() - t0:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
