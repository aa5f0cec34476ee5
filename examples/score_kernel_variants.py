#!/usr/bin/env python3
"""Variants of ``csrc/megastep.cu``'s ``score_kernel``, built side by side
and timed beside this checkout's kernel on one card.

    python3 examples/score_kernel_variants.py OUT_DIR [--check] [NAME ...]

Each variant (all of ``VARIANTS`` when no NAME is given) is this
checkout's ``captionkit_torch`` and ``chip_smoke.py`` copied into
OUT_DIR/NAME with text patches applied to ``csrc/megastep.cu``:

- ``base``: no patch (this checkout's kernel again: the runs' spread);
- ``tanh_ex2``: the bf16 instances score with ``tanh_ex2`` (MUFU.EX2 and
  MUFU.RCP a term) in place of ``tanh_approx`` (one MUFU.TANH);
- ``warps2``, ``warps4``: two or four warps a query row in place of one,
  taking its position pairs in turn (``warps4`` with four rows a block,
  so a block stays within 512 threads);
- ``l1_keys``: no keys staged in shared memory, each warp reads its keys
  from device memory through L1; ``l1_keys_warps2`` also two warps a
  row;
- ``head_copy``: the block's head a copy selected in registers by
  blockIdx.z, in place of a reference into the kernel's parameters;
- ``p_outer_staging``: the keys staged a position at a time, each
  position's 16-byte copies over the threads (no division a copy).

The variants' megastep libraries and this checkout's build in parallel
(each source's registers, shared memory and spills of ``score_kernel``
printed as one JSON line a variant). ``--check``: in each variant, in a
process of its own, ``chip_smoke.py``'s ``megastep`` phase (att_cell and
dcnet_score against their plain versions within one bf16 ulp at paper
shape, on the model's encoded keys and on random keys) and its
``decode_cells`` phase (the fused EditNet step against the plain step on
the decode's own states, 22 steps, with att_cell's α and β within one
bf16 ulp at each); each phase's line is printed whether
it held its bars or not. Then ``examples/profile_score_kernels.py
--cases att_cell,dcnet_score`` for this checkout and every variant, one
JSON line each. Needs the card; imports nothing of JAX.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
L1_KEYS = [
    ("for (int i = threadIdx.x; i < n * chunks; i += blockDim.x) {",
     "for (int i = threadIdx.x; i < 0; i += blockDim.x) {"),
    ("score_pair<NC, KT>(sk + (size_t)(p0 - t0) * A,\n"
     "                           sk + (size_t)(p1 - t0) * A,",
     "score_pair<NC, KT>(kimg + (size_t)p0 * A, kimg + (size_t)p1 * A,")]
WARPS2 = [("constexpr int SK_WARPS = 1;", "constexpr int SK_WARPS = 2;")]
# Each variant: (old, new) text patches of megastep.cu.
VARIANTS = {
    "base": [],
    "tanh_ex2": [("sm90::tanh_approx(", "sm90::tanh_ex2(")],
    "warps2": WARPS2,
    "warps4": [("constexpr int SK_WARPS = 1;", "constexpr int SK_WARPS = 4;"),
               ("constexpr int SK_ROWS = 8;", "constexpr int SK_ROWS = 4;")],
    "l1_keys": L1_KEYS,
    "l1_keys_warps2": L1_KEYS + WARPS2,
    "head_copy": [("const ScoreHead& hd = a.head[blockIdx.z];",
                   "const ScoreHead hd = blockIdx.z ? a.head[1] "
                   ": a.head[0];")],
    "p_outer_staging": [
        ("    for (int i = threadIdx.x; i < n * chunks; i += blockDim.x) {\n"
         "      const int p = i / chunks;\n"
         "      if (mimg && !(mimg[t0 + p] > 0.0f)) continue;\n"
         "      const size_t e = (size_t)p * A + (size_t)(i - p * chunks) * "
         "VEC;",
         "    for (int p = 0; p < n; ++p) {\n"
         "      if (mimg && !(mimg[t0 + p] > 0.0f)) continue;\n"
         "      for (int c = threadIdx.x; c < chunks; c += blockDim.x) {\n"
         "      const size_t e = (size_t)p * A + (size_t)c * VEC;"),
        (': "memory");\n    }\n    asm volatile("cp.async.commit_group;"',
         ': "memory");\n    }}\n    asm volatile("cp.async.commit_group;"')],
}
BUILD = r"""
import json, sys
sys.path.insert(0, ".")
import chip_smoke
from captionkit_torch.kernels import build
logs = {}
build.build(["megastep"], reports=logs)
print(json.dumps({"variant": sys.argv[1], "ptxas": {  # {} when up to date
    k: v for k, v in chip_smoke._ptxas(logs.get("megastep", "")).items()
    if "score_kernel" in k}}), flush=True)
"""
CHECK = r"""
import json, sys, traceback
sys.path.insert(0, ".")
import chip_smoke as cs
from captionkit_torch.kernels import WRAPPERS
from captionkit_torch.models import get_model
card = cs.phase_device()["nvidia_smi"]
ed = cs._paper_setup("editnet_beam5")
dc = cs._paper_setup("dcnet_beam5", {"model.cell_impl": "pallas"})
pallas = ed[0].override({"model.cell_impl": "pallas"})
for name, run in (
        ("megastep", lambda: cs.phase_megastep(ed, dc)),
        ("decode_cells", lambda: cs.phase_decode_cells(
            pallas, get_model(pallas.model), ed[2], ed[3], WRAPPERS,
            card))):
    try:
        run()
    except Exception as e:
        traceback.print_exc()
        print(json.dumps({"variant": sys.argv[1], "phase": name,
                          "ok": False, "error": str(e)}), flush=True)
"""


def make_variant(out: Path, patches) -> None:
    """``out``: this checkout's port with ``patches`` applied to
    csrc/megastep.cu (each old text must occur)."""
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    shutil.copytree(HERE / "captionkit_torch", out / "captionkit_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(HERE / "chip_smoke.py", out / "chip_smoke.py")
    src = out / "captionkit_torch" / "csrc" / "megastep.cu"
    text = src.read_text()
    for old, new in patches:
        if old not in text:
            raise SystemExit(f"{src}: no {old!r} to patch")
        text = text.replace(old, new)
    src.write_text(text)


def main() -> int:
    args = sys.argv[1:]
    if not args:
        raise SystemExit(__doc__)
    root = Path(args.pop(0)).resolve()
    check = "--check" in args
    names = [a for a in args if a != "--check"] or list(VARIANTS)
    dirs = {name: root / name for name in names}
    for name, out in dirs.items():
        make_variant(out, VARIANTS[name])
    builds = [subprocess.Popen([sys.executable, "-c", BUILD, name], cwd=out)
              for name, out in {"this checkout": HERE, **dirs}.items()]
    if any([p.wait(timeout=900) for p in builds]):
        return 1
    if check:
        for name, out in dirs.items():
            subprocess.run([sys.executable, "-c", CHECK, name], cwd=out,
                           timeout=1500)
    return subprocess.run(
        [sys.executable, str(HERE / "examples" / "profile_score_kernels.py"),
         "--cases", "att_cell,dcnet_score", str(HERE),
         *map(str, dirs.values())], timeout=3000).returncode


if __name__ == "__main__":
    sys.exit(main())
