#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s device, build, train and data_parallel phases
alone, on one card: the quick check of data parallelism (a world of one
over NCCL against the plain step; two ranks sharing the card over gloo
against one process: XE steps, an SCST gradient, the sharded decode;
``cli train-xe --num-shards 2``). The train phase makes the split and the
XE weights the data_parallel phase starts from.

    python3 examples/torch_parallel_phase.py

Prints the phases' JSON lines (as ``chip_smoke.py`` prints them) and the
seconds the whole run took. The synthetic split is deleted at the end.
"""

import shutil
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

    try:
        chip_smoke.phase_train(WRAPPERS, info["nvidia_smi"])
        chip_smoke.phase_data_parallel(WRAPPERS, info["nvidia_smi"])
    finally:
        shutil.rmtree(chip_smoke.SMOKE_DIR / "train", ignore_errors=True)
    print(f"seconds {time.time() - t0:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
