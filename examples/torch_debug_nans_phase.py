#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s device, build and ``debug_nans`` phases alone,
on one card: ``--debug-nans`` at paper width (the kernel paths' decodes,
an XE step and an SCST step with clean weights and the flag on, a planted
NaN that must raise, the flag's cost in turns, each kernel's NaN record).

    python3 examples/torch_debug_nans_phase.py

Prints the phases' JSON lines (as ``chip_smoke.py`` prints them) and the
seconds the whole run took.
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

    ed = chip_smoke._paper_setup("editnet_beam5")
    dc = chip_smoke._paper_setup("dcnet_beam5", {"model.cell_impl": "pallas"})
    chip_smoke.phase_debug_nans(ed, dc, WRAPPERS, info["nvidia_smi"])
    print(f"seconds {time.time() - t0:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
