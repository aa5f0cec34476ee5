"""ctypes binding of the native CIDEr-D scorer (``native/cider.cpp``; a
copy of ``captionkit.metrics.fast``).

``NativeCiderD`` scores CIDEr-D against a precomputed document-frequency
corpus in C++; its per-image scores equal ``CiderD.compute()[1]`` up to
the order of the float64 sums (within 1e-9). The library is built at
first use (``utils.nativebuild``); a failed build raises.

Tokens are interned to dense int32 ids per scorer instance: n-gram keys
are raw id-sequence bytes, so equality is exactly string-token equality.
``intern_references`` turns references into ids once, where their owner
holds them (the SCST loop: the training set's, at its start), and
``score_sets`` scores several hypothesis sets against those ids in one
call (the SCST reward: sample and greedy captions, or n samples).
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
    lib.cider_d_score_sets.restype = None
    lib.cider_d_score_sets.argtypes = [ctypes.c_void_p, ctypes.c_int64, i32,
                                       i32, i32, i32, i32, ctypes.c_int64,
                                       f64]
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

    def _ids(self, tokens: Sequence[str], flat: list[int]) -> int:
        flat.extend(self._tok_id(t) for t in tokens)
        return len(tokens)

    def intern_references(
        self, references: Sequence[Sequence[Sequence[str]]]
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Each image's references as int32 (token ids, lengths), the form
        ``score_sets`` takes. A token's id never changes once given, so
        the ids stay valid for every later call of this scorer."""
        out = []
        for refs in references:
            flat: list[int] = []
            lens = [self._ids(r, flat) for r in refs]
            out.append((np.asarray(flat, np.int32),
                        np.asarray(lens, np.int32)))
        return out

    def score_sets(
        self,
        hypothesis_sets: Sequence[Sequence[Sequence[str]]],
        reference_ids: Sequence[tuple[np.ndarray, np.ndarray]],
    ) -> np.ndarray:
        """[S, B] per-image CIDEr-D scores of S hypothesis sets against the
        same B images' references (``intern_references``), in one native
        call that builds each image's reference vectors once. The
        hypotheses are interned set by set, in the order S ``score`` calls
        would intern them, so every score is bit-equal to scoring its set
        alone."""
        B = len(reference_ids)
        hyp_flat: list[int] = []
        hyp_lens: list[int] = []
        for hyps in hypothesis_sets:
            if len(hyps) != B:
                raise ValueError("hypotheses and references must align")
            hyp_lens.extend(self._ids(h, hyp_flat) for h in hyps)
        S = len(hypothesis_sets)
        ref_flat = np.concatenate([i for i, _ in reference_ids] + [[0]])
        ref_lens = np.concatenate([n for _, n in reference_ids] + [[0]])
        refs_per_img = np.array([len(n) for _, n in reference_ids],
                                np.int32)
        out = np.zeros(S * B, np.float64)
        self._lib.cider_d_score_sets(
            self._handle, S, np.asarray(hyp_flat or [0], np.int32),
            np.asarray(hyp_lens or [0], np.int32),
            ref_flat.astype(np.int32), ref_lens.astype(np.int32),
            refs_per_img, B, out)
        return out.reshape(S, B)

    def score(
        self,
        hypotheses: Sequence[Sequence[str]],
        references: Sequence[Sequence[Sequence[str]]],
    ) -> np.ndarray:
        """Per-image CIDEr-D scores (matches CiderD.compute()[1])."""
        if len(hypotheses) != len(references):
            raise ValueError("hypotheses and references must align")
        return self.score_sets([hypotheses],
                               self.intern_references(references))[0]
