"""Row-gather view over a ``.npy`` feature file (a copy of
``captionkit.data.faststore``).

``FeatureStore.gather`` assembles a batch of feature rows with
``native/featstore.cpp``: a threaded memcpy from a memory map, outside the
interpreter lock, with no numpy fancy-indexing temporaries. The library is
built at first use (``utils.nativebuild``); a failed build raises.

The native path takes plain little-endian C-contiguous ``.npy`` files of
float32, float16, int32, int64 or uint8 (what ``data.prepare`` writes).
Any other file (another dtype such as float64, Fortran order, big-endian,
not a ``.npy``) is read through the numpy mmap gather, as the reference
reads it; the route is chosen from the file's header before anything is
built. ``native=False`` takes the numpy gather for every file.
"""

from __future__ import annotations

import ast
import ctypes
import os
import struct
from typing import Optional

import numpy as np

from captionkit_torch.data.pipeline import take_rows
from captionkit_torch.utils import nativebuild

_NATIVE_DTYPES = ("<f4", "<f2", "<i4", "<i8", "|u1")


def _load_lib() -> ctypes.CDLL:
    lib = nativebuild.load("featstore")
    lib.featstore_open.restype = ctypes.c_void_p
    lib.featstore_open.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                   ctypes.c_int64, ctypes.c_int64]
    lib.featstore_close.restype = None
    lib.featstore_close.argtypes = [ctypes.c_void_p]
    lib.featstore_gather.restype = ctypes.c_int
    lib.featstore_gather.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
    lib.featstore_rows.restype = ctypes.c_int64
    lib.featstore_rows.argtypes = [ctypes.c_void_p]
    return lib


def _parse_npy_header(path: str):
    """(payload_offset, shape, dtype) of a v1/v2 ``.npy`` file, or None
    when the layout is not the contiguous little-endian case the native
    gather takes."""
    with open(path, "rb") as f:
        if f.read(6) != b"\x93NUMPY":
            return None
        major, _minor = f.read(1)[0], f.read(1)[0]
        if major == 1:
            (hlen,) = struct.unpack("<H", f.read(2))
            header_start = 10
        else:
            (hlen,) = struct.unpack("<I", f.read(4))
            header_start = 12
        header = f.read(hlen).decode("latin1")
    meta = ast.literal_eval(header)
    if meta.get("fortran_order") or meta["descr"] not in _NATIVE_DTYPES:
        return None
    return header_start + hlen, tuple(meta["shape"]), np.dtype(meta["descr"])


class FeatureStore:
    """Row-gather view over a ``.npy`` feature file:
    ``gather(indices) -> [n, *row_shape]``."""

    def __init__(self, path: str, *, threads: Optional[int] = None,
                 native: bool = True):
        self.path = path
        self._threads = threads or min(8, os.cpu_count() or 1)
        self._native = None
        self._np = None
        parsed = (_parse_npy_header(path)
                  if native and path.endswith(".npy") else None)
        if parsed is None:
            self._np = np.load(path, mmap_mode="r")
            self.shape = self._np.shape
            self.dtype = self._np.dtype
            return
        offset, self.shape, self.dtype = parsed
        row_bytes = int(np.prod(self.shape[1:])) * self.dtype.itemsize
        lib = _load_lib()
        handle = lib.featstore_open(path.encode(), offset, self.shape[0],
                                    row_bytes)
        if not handle:
            raise OSError(f"{path}: cannot map {self.shape[0]} rows of "
                          f"{row_bytes} bytes")
        self._native = (lib, ctypes.c_void_p(handle))

    @property
    def is_native(self) -> bool:
        return self._native is not None

    def gather(self, indices, out: Optional[np.ndarray] = None
               ) -> np.ndarray:
        """The rows ``indices``, into ``out`` when given (an array of
        ``[len(indices), *row_shape]``; another dtype than the file's
        takes a cast)."""
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        shape = (idx.shape[0], *self.shape[1:])
        if out is not None and out.shape != shape:
            raise ValueError(f"out has shape {out.shape}, not {shape}")
        if self._np is not None:
            if out is None:
                return np.asarray(self._np[idx])
            return take_rows(self._np, idx, out)
        if self._native is None:
            raise ValueError(f"{self.path}: the feature store is closed")
        lib, handle = self._native
        direct = (out is not None and out.dtype == self.dtype
                  and out.flags.c_contiguous and out.flags.writeable)
        dst = out if direct else np.empty(shape, self.dtype)
        rc = lib.featstore_gather(handle, idx, idx.shape[0],
                                  dst.ctypes.data_as(ctypes.c_void_p),
                                  self._threads)
        if rc != 0:
            raise IndexError(
                f"feature index out of range [0, {self.shape[0]})")
        if out is not None and not direct:
            out[...] = dst
            return out
        return dst

    def __len__(self) -> int:
        return int(self.shape[0])

    def __getitem__(self, idx) -> np.ndarray:
        if isinstance(idx, (int, np.integer)):
            return self.gather(np.asarray([idx]))[0]
        return self.gather(np.asarray(idx))

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        out = self.gather(np.arange(self.shape[0]))
        return out.astype(dtype) if dtype is not None else out

    def close(self) -> None:
        if self._native is not None:
            lib, handle = self._native
            lib.featstore_close(handle)
            self._native = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
