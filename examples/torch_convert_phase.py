#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s device, build, convert and introspect phases
alone, on one card: the checkpoint converter and the parity gate at paper
width, then the attention traces at batch 512.

    python3 examples/torch_convert_phase.py

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

    card = info["nvidia_smi"]
    ed = chip_smoke._paper_setup("editnet_beam5")
    chip_smoke._paper_setup("dcnet_beam5", {"model.cell_impl": "pallas"})
    t1 = time.time()
    chip_smoke.phase_convert(WRAPPERS, card)
    t2 = time.time()
    chip_smoke.phase_introspect(ed, WRAPPERS, card)
    print(f"seconds {time.time() - t0:.1f} (convert {t2 - t1:.1f}, "
          f"introspect {time.time() - t2:.1f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
