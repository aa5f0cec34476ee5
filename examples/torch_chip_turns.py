#!/usr/bin/env python3
"""Compare two checkouts of the PyTorch port on one card, in turns.

    python3 examples/torch_chip_turns.py PARENT_DIR [CHANGE_DIR] --out DIR
        [--phases fp32,head_variants,megastep,cell_kernels,wide_head,...]

Runs ``python3 chip_smoke.py`` in PARENT_DIR and CHANGE_DIR (default: this
checkout) in the order parent, change, change, parent, each as its own
process, and writes each run's output to DIR/<label>_<n>.log. With
``--phases``, each run is instead the device and build phases, the paper
setups, and only the named phases of that checkout's ``chip_smoke.py``
(any of decode, decode_cells, greedy, introspect, fp32, head_variants,
megastep, cell_kernels, wholestep, wide_head). Then prints
one JSON object: for every kernel of the runs' ``kernels`` lines its ms per
run, for every measured field of the kernels' rows (each launch's device
time and a call's device span where a row gives them, and a score stage's
device times and bound share; the ``cell_kernels`` times, the
``head_variants``, ``megastep``, ``fp32``, ``beam10`` and ``wide_head``
kernels, the ``wholestep`` kernel and the two programs it is set against)
their values per run, and every captions/s figure of the decode
phases per run, each with the change's mean over the parent's. Fails if
any run fails. Imports nothing of JAX; needs the card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("ms", "device_ms", "library_ms", "library_device_ms", "plain_ms",
          "bound_ms", "bound_share", "device_bound_share",
          "cuda_launches_per_call", "two_programs_ms",
          "two_programs_device_ms", "lang_cell_then_sweep_ms",
          "lang_cell_then_sweep_device_ms", "device_span_ms",
          "device_span_bound_share")
# A score stage's fields (chip_smoke.py's ``_score_stage``).
STAGE_FIELDS = ("scores_kernel_device_ms", "scores_stage_device_ms",
                "call_span_device_ms", "stage_bound_share", "bound_ms")


# The named phases of a checkout's chip_smoke.py, after its device and
# build phases and the paper setups (as its main() runs them).
PHASES = r"""
import sys
sys.path.insert(0, ".")
import chip_smoke as cs
card = cs.phase_device()["nvidia_smi"]
cs.phase_build()
from captionkit_torch.kernels import WRAPPERS
from captionkit_torch.models import get_model
ed = cs._paper_setup("editnet_beam5")
dc = cs._paper_setup("dcnet_beam5", {"model.cell_impl": "pallas"})
pallas = ed[0].override({"model.cell_impl": "pallas"})
run = {"decode": lambda: cs.phase_decode(*ed, WRAPPERS, card),
       "decode_cells": lambda: cs.phase_decode_cells(
           pallas, get_model(pallas.model), ed[2], ed[3], WRAPPERS, card),
       "wholestep": lambda: cs.phase_wholestep(ed, WRAPPERS, card),
       "greedy": lambda: cs.phase_greedy(ed, dc, WRAPPERS, card),
       "introspect": lambda: cs.phase_introspect(ed, WRAPPERS, card),
       "fp32": lambda: cs.phase_fp32(ed, dc, WRAPPERS, card),
       "head_variants": cs.phase_head_variants,
       "megastep": lambda: cs.phase_megastep(ed, dc),
       "cell_kernels": lambda: cs.phase_cell_kernels(ed, dc),
       "wide_head": lambda: cs.phase_wide_head(card)}
for name in sys.argv[1].split(","):
    run[name]()
"""
PHASE_NAMES = ("decode", "decode_cells", "greedy", "introspect", "fp32",
               "head_variants", "megastep", "cell_kernels", "wholestep",
               "wide_head")


def run(checkout: Path, log: Path, phases: str = "") -> list[dict]:
    cmd = [sys.executable] + (["-c", PHASES, phases] if phases
                              else ["chip_smoke.py"])
    proc = subprocess.run(cmd, cwd=checkout, capture_output=True, text=True,
                          timeout=1500)
    log.write_text(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    if proc.returncode != 0:
        raise SystemExit(f"chip_smoke.py in {checkout} exited "
                         f"{proc.returncode}; see {log}")
    lines = []
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            lines.append(json.loads(line))
    return lines


def captions(obj, path=()):
    """Every captions/s figure in a phase line, by its key path."""
    if isinstance(obj, dict):
        for key, value in obj.items():
            if key == "captions_per_s" and isinstance(value, (int, float)):
                yield "/".join(path), value
            else:
                yield from captions(value, path + (key,))


def stage(out: dict, prefix: str, t: dict) -> None:
    """A score stage's fields of ``t`` under ``prefix``."""
    for f in STAGE_FIELDS:
        if t.get(f) is not None:
            out[f"{prefix}/{f}"] = t[f]


def summary(lines: list[dict]) -> dict:
    out = {}
    for line in lines:
        if "kernels" in line and isinstance(line["kernels"], list):
            for k in line["kernels"]:
                out[f"kernel/{k['name']}/ms"] = k["ms"]
        phase = line.get("phase")
        if phase == "cell_kernels":
            for name, t in line["times"].items():
                for f in FIELDS:
                    if t.get(f) is not None:
                        out[f"cell_kernels/{name}/{f}"] = t[f]
                for label, v in t.get("device_ms_by_launch", {}).items():
                    out[f"cell_kernels/{name}/device_ms/{label}"] = v
                if "scores_stage_device_ms" in t:
                    stage(out, f"cell_kernels/{name}/score_stage", t)
        if phase in ("head_variants", "megastep", "fp32", "beam10",
                     "wide_head"):
            for name, t in line["kernels"].items():
                for f in FIELDS:
                    if t.get(f) is not None:
                        out[f"{phase}/{name}/{f}"] = t[f]
                for label, v in t.get("device_ms_by_launch", {}).items():
                    out[f"{phase}/{name}/device_ms/{label}"] = v
                if "score_stage" in t:
                    stage(out, f"{phase}/{name}/score_stage",
                          t["score_stage"])
        if phase == "wholestep":
            for f in FIELDS:
                if line["kernel"].get(f) is not None:
                    out[f"wholestep/fused_lang_head_topk/{f}"] = \
                        line["kernel"][f]
        if phase is not None:
            for path, value in captions(line):
                out[f"{phase}/{path}/captions_per_s"] = value
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path, nargs="?", default=ROOT)
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--phases", default="",
                    help="run only these phases (comma-separated)")
    args = ap.parse_args()
    unknown = set(filter(None, args.phases.split(","))) - set(PHASE_NAMES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}; known: {PHASE_NAMES}")
    args.out.mkdir(parents=True, exist_ok=True)
    order = [("parent", args.parent), ("change", args.change),
             ("change", args.change), ("parent", args.parent)]
    runs = {"parent": [], "change": []}
    smi = None
    for n, (label, checkout) in enumerate(order, 1):
        lines = run(checkout.resolve(), args.out / f"{label}_{n}.log",
                    args.phases)
        runs[label].append(summary(lines))
        smi = smi or next((ln.get("nvidia_smi") for ln in lines
                           if ln.get("phase") == "device"), None)
    keys = sorted(set(runs["change"][0]) | set(runs["parent"][0]))
    table = {}
    for key in keys:
        p = [r[key] for r in runs["parent"] if key in r]
        c = [r[key] for r in runs["change"] if key in r]
        row = {"parent": p, "change": c}
        if p and c and statistics.mean(p):
            row["change_over_parent"] = statistics.mean(c) / statistics.mean(p)
        table[key] = row
    print(json.dumps({"card": smi, "order": [o[0] for o in order],
                      "metrics": table}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
