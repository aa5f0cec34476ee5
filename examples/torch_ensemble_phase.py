#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s device, build, wide_head and ensemble phases
alone, on one card: the tiled bf16 heads at H = 2048 and 4096 against
their plain versions, then editnet_beam5 as a two-member checkpoint
ensemble and the stacked DCNet -> EditNet pipeline at batch 512.

    python3 examples/torch_ensemble_phase.py

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
    chip_smoke.phase_wide_head(card)
    ed = chip_smoke._paper_setup("editnet_beam5")
    dc = chip_smoke._paper_setup("dcnet_beam5",
                                 {"model.cell_impl": "pallas"})
    chip_smoke.phase_ensemble(ed, dc, WRAPPERS, card)
    print(f"seconds {time.time() - t0:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
