"""Build the host C++ helpers in ``captionkit_torch/native`` and load them.

Each ``native/<name>.cpp`` (``cider``: the CIDEr-D scorer of
``metrics.fast``; ``featstore``: the row gather of ``data.faststore``) is
compiled at first use by ``g++`` (``$CXX`` when set) into a shared library
with a plain C interface, ``build/captionkit_torch/lib<name>-<hash>.so``
under the repository root, and loaded with ``ctypes``. The hash covers the
source, the flags and the compiler's version, so an edited source or
another compiler gets a library of its own. A library is compiled to a
temporary name and renamed into place (``rename`` is atomic), so a process
that loads it never sees a half-written file.

A build that fails raises ``RuntimeError`` with the compiler's output;
nothing steps down to a Python twin.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "captionkit_torch"
# No -march=native: a build directory may be copied to another host, and
# the library must load there (the compiler's version is in the hash, the
# CPU is not).
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")
LINK_FLAGS = {"cider": (), "featstore": ("-lpthread",)}

_loaded: dict[str, ctypes.CDLL] = {}


def compiler() -> tuple[str, str]:
    """(the C++ compiler, its version line): ``$CXX``, else ``g++``."""
    cxx = os.environ.get("CXX") or "g++"
    try:
        proc = subprocess.run([cxx, "--version"], capture_output=True,
                              text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(
            f"the C++ compiler {cxx!r} cannot run ({e}); the host libraries "
            "of captionkit_torch are built from source at first use") from e
    return cxx, proc.stdout.splitlines()[0] if proc.stdout else ""


def library_path(name: str, version: str) -> Path:
    digest = hashlib.sha256(
        " ".join((*CXX_FLAGS, *LINK_FLAGS[name], version)).encode())
    digest.update((NATIVE_DIR / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(name: str) -> Path:
    """The library of ``native/<name>.cpp``, compiled first if it has no
    current one. Raises ``RuntimeError`` (after printing the compiler's
    output) when the compiler fails."""
    cxx, version = compiler()
    out = library_path(name, version)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(NATIVE_DIR / f"{name}.cpp"),
           *LINK_FLAGS[name]]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        log = proc.stdout + proc.stderr
        print(log, file=sys.stderr, flush=True)
        raise RuntimeError(
            f"{cxx} {name}.cpp failed ({proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``native/<name>.cpp``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib
