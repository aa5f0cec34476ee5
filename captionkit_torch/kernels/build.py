"""Build the CUDA sources in ``captionkit_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` into a shared
library with a plain C interface, ``build/captionkit_torch/lib<name>-<hash>.so``
under the repository root, and loaded with ``ctypes``. The hash covers the
sources (headers included) and the flags, so an edited source is rebuilt.
Sources build in parallel, one ``nvcc`` each. Nothing is prebuilt: a fresh
checkout builds in seconds because no source includes PyTorch's headers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "captionkit_torch"
SOURCES = ("head_topk", "head_sweep", "head_int8", "megastep", "lstm",
           "attention", "wholestep")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels of "
            "captionkit_torch are built from source at first use")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=SOURCES, *, reports: dict | None = None) -> dict[str, float]:
    """Compile every named source that has no current library, all at
    once. Returns {name: seconds} for the ones built (0.0 = up to date).
    ``reports``: a dict that receives, for each source built, the
    compiler's report of registers, shared memory and spills
    (``-Xptxas -v``)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc() if any(not library_path(n).exists() for n in names) \
        else None
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS,
               *(["-Xptxas", "-v"] if reports is not None else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc {name}.cu failed ({proc.returncode}):\n"
                            f"{log}")
            continue
        if reports is not None:
            reports[name] = log
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
