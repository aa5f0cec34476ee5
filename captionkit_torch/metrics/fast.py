"""ctypes binding of the native CIDEr-D scorer (``native/cider.cpp``; a
copy of ``captionkit.metrics.fast``).

``NativeCiderD`` scores CIDEr-D against a precomputed document-frequency
corpus in C++; its per-image scores equal ``CiderD.compute()[1]`` up to
the order of the float64 sums (within 1e-9). The library is built at
first use (``utils.nativebuild``); a failed build raises.

Tokens are interned to dense int32 ids per scorer instance: n-gram keys
are raw id-sequence bytes, so equality is exactly string-token equality.
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence

import numpy as np

from captionkit_torch.metrics.cider import MAX_N, NgramDocFreq
from captionkit_torch.utils import nativebuild


def _load_lib() -> ctypes.CDLL:
    lib = nativebuild.load("cider")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.cider_new.restype = ctypes.c_void_p
    lib.cider_new.argtypes = [ctypes.c_double]
    lib.cider_free.restype = None
    lib.cider_free.argtypes = [ctypes.c_void_p]
    lib.cider_set_df.restype = None
    lib.cider_set_df.argtypes = [ctypes.c_void_p, i32, i32, f64,
                                 ctypes.c_int64, ctypes.c_int64]
    lib.cider_d_score.restype = None
    lib.cider_d_score.argtypes = [ctypes.c_void_p, i32, i32, i32, i32, i32,
                                  ctypes.c_int64, f64]
    return lib


class NativeCiderD:
    """CIDEr-D against a precomputed df corpus, scored in C++."""

    def __init__(self, df: NgramDocFreq, sigma: float = 6.0):
        if df.max_n != MAX_N:
            raise ValueError(f"native scorer supports max_n={MAX_N} only")
        self._lib = _load_lib()
        self._handle = ctypes.c_void_p(self._lib.cider_new(sigma))
        self._intern: dict[str, int] = {}
        # Intern the df vocabulary and ship the table.
        flat: list[int] = []
        orders = np.empty(len(df.df), np.int32)
        counts = np.empty(len(df.df), np.float64)
        for i, (gram, cnt) in enumerate(df.df.items()):
            orders[i] = len(gram)
            counts[i] = cnt
            flat.extend(self._tok_id(t) for t in gram)
        self._lib.cider_set_df(
            self._handle, np.asarray(flat or [0], np.int32), orders, counts,
            len(df.df), df.corpus_size)

    def _tok_id(self, tok: str) -> int:
        tid = self._intern.get(tok)
        if tid is None:
            tid = len(self._intern)
            self._intern[tok] = tid
        return tid

    def close(self) -> None:
        if self._handle is not None:
            self._lib.cider_free(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - interpreter teardown
        try:
            self.close()
        except Exception:
            pass

    def score(
        self,
        hypotheses: Sequence[Sequence[str]],
        references: Sequence[Sequence[Sequence[str]]],
    ) -> np.ndarray:
        """Per-image CIDEr-D scores (matches CiderD.compute()[1])."""
        if len(hypotheses) != len(references):
            raise ValueError("hypotheses and references must align")
        B = len(hypotheses)
        hyp_flat: list[int] = []
        hyp_lens = np.empty(B, np.int32)
        ref_flat: list[int] = []
        ref_lens: list[int] = []
        refs_per_img = np.empty(B, np.int32)
        for b, (hyp, refs) in enumerate(zip(hypotheses, references)):
            hyp_lens[b] = len(hyp)
            hyp_flat.extend(self._tok_id(t) for t in hyp)
            refs_per_img[b] = len(refs)
            for r in refs:
                ref_lens.append(len(r))
                ref_flat.extend(self._tok_id(t) for t in r)
        out = np.zeros(B, np.float64)
        self._lib.cider_d_score(
            self._handle,
            np.asarray(hyp_flat or [0], np.int32), hyp_lens,
            np.asarray(ref_flat or [0], np.int32),
            np.asarray(ref_lens or [0], np.int32),
            refs_per_img, B, out)
        return out
