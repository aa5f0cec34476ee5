"""CIDEr and CIDEr-D (a copy of ``captionkit.metrics.cider``), with
pycocoevalcap's algorithms:

* tf-idf n-gram vectors per sentence, n = 1..4; idf = log(corpus_size) -
  log(max(1, df[ngram])) with df counted once per *image* over its refs.
* CIDEr: per-n cosine similarity hyp.ref / (|hyp||ref|), averaged over
  refs and n, x10.
* CIDEr-D: numerator uses clipped counts min(hyp, ref).ref and multiplies
  a Gaussian length penalty exp(-(len_h - len_r)^2 / (2 sigma^2)),
  sigma = 6.

``NgramDocFreq`` is the precomputable document-frequency corpus (an SCST
reward must not depend on the batch's composition): build it once from
the training references, save and load it as ``.npz``. Every loop and
``Counter``/dict walk is the reference's, in the same order, so the
float64 sums are bit-identical to it.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from collections.abc import Sequence
from typing import Optional

import numpy as np

from captionkit_torch.metrics.ngrams import ngram_counts_upto

SIGMA = 6.0
MAX_N = 4


class NgramDocFreq:
    """Document frequencies over a reference corpus."""

    def __init__(self, df: dict[tuple, float], corpus_size: int,
                 max_n: int = MAX_N):
        self.df = df
        self.corpus_size = corpus_size
        self.max_n = max_n

    @classmethod
    def build(
        cls,
        references: Sequence[Sequence[Sequence[str]]],
        max_n: int = MAX_N,
    ) -> "NgramDocFreq":
        """references[i] = list of token lists for image i."""
        df: dict[tuple, float] = defaultdict(float)
        for refs in references:
            seen = set()
            for r in refs:
                seen.update(ngram_counts_upto(r, max_n).keys())
            for g in seen:
                df[g] += 1.0
        return cls(dict(df), len(references), max_n)

    @property
    def log_corpus(self) -> float:
        return math.log(max(self.corpus_size, 1))

    def save(self, path: str) -> None:
        grams = list(self.df.keys())
        np.savez_compressed(
            path,
            grams=np.asarray(
                ["␟".join(g) for g in grams], dtype=object
            ),
            counts=np.asarray([self.df[g] for g in grams], np.float64),
            corpus_size=self.corpus_size,
            max_n=self.max_n,
        )

    @classmethod
    def load(cls, path: str) -> "NgramDocFreq":
        data = np.load(path, allow_pickle=True)
        grams = [tuple(s.split("␟")) for s in data["grams"]]
        df = dict(zip(grams, data["counts"].tolist()))
        return cls(df, int(data["corpus_size"]), int(data["max_n"]))


def _tfidf_vec(
    counts: Counter, df: NgramDocFreq
) -> tuple[list[dict], list[float], int]:
    """counts -> (per-n sparse vec, per-n norm, unigram length)."""
    vec: list[dict] = [{} for _ in range(df.max_n)]
    norm = [0.0] * df.max_n
    length = 0
    log_corpus = df.log_corpus
    for gram, tf in counts.items():
        idf = log_corpus - math.log(max(1.0, df.df.get(gram, 0.0)))
        n = len(gram) - 1
        vec[n][gram] = tf * idf
        norm[n] += vec[n][gram] ** 2
        if n == 0:
            length += tf
    return vec, [math.sqrt(x) for x in norm], length


def _sim(
    vec_h, vec_r, norm_h, norm_r, len_h, len_r, *, clipped: bool,
    length_penalty: bool,
) -> np.ndarray:
    delta = float(len_h - len_r)
    val = np.zeros(len(vec_h))
    for n in range(len(vec_h)):
        v = 0.0
        ref_n = vec_r[n]
        for gram, w in vec_h[n].items():
            rw = ref_n.get(gram, 0.0)
            v += (min(w, rw) if clipped else w) * rw
        if norm_h[n] != 0 and norm_r[n] != 0:
            v /= norm_h[n] * norm_r[n]
        if length_penalty:
            v *= math.exp(-(delta ** 2) / (2 * SIGMA ** 2))
        val[n] = v
    return val


class _CiderBase:
    _clipped: bool
    _length_penalty: bool

    def __init__(self, df: Optional[NgramDocFreq] = None, max_n: int = MAX_N):
        self.df = df
        self.max_n = max_n

    def compute(
        self,
        hypotheses: Sequence[Sequence[str]],
        references: Sequence[Sequence[Sequence[str]]],
    ) -> tuple[float, np.ndarray]:
        """Returns (corpus score, per-image scores). When no df corpus was
        given, it is built from `references` (the toolkit's corpus mode)."""
        if len(hypotheses) != len(references):
            raise ValueError("hypotheses and references must align")
        df = self.df or NgramDocFreq.build(references, self.max_n)
        scores = np.zeros(len(hypotheses))
        for i, (hyp, refs) in enumerate(zip(hypotheses, references)):
            vec_h, norm_h, len_h = _tfidf_vec(
                ngram_counts_upto(hyp, self.max_n), df
            )
            acc = np.zeros(self.max_n)
            for r in refs:
                vec_r, norm_r, len_r = _tfidf_vec(
                    ngram_counts_upto(r, self.max_n), df
                )
                acc += _sim(
                    vec_h, vec_r, norm_h, norm_r, len_h, len_r,
                    clipped=self._clipped,
                    length_penalty=self._length_penalty,
                )
            score = np.mean(acc / max(len(refs), 1)) * 10.0
            scores[i] = score
        return float(scores.mean()) if len(scores) else 0.0, scores


class Cider(_CiderBase):
    """Plain CIDEr (unclipped, no length penalty)."""

    _clipped = False
    _length_penalty = False


class CiderD(_CiderBase):
    """CIDEr-D: the metric the evaluator reports as "CIDEr", and the SCST
    reward."""

    _clipped = True
    _length_penalty = True
