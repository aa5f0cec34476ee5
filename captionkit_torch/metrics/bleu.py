"""Corpus BLEU-1..4 (a copy of ``captionkit.metrics.bleu``), with
pycocoevalcap's semantics: clipped modified n-gram precision, corpus-level
aggregation, the 'closest' reference length for the brevity penalty, and
the toolkit's small-ratio guard.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

from captionkit_torch.metrics.ngrams import ngram_counts

_TINY = 1e-15
_SMALL = 1e-9


def bleu_scores(
    hypotheses: Sequence[Sequence[str]],
    references: Sequence[Sequence[Sequence[str]]],
    max_n: int = 4,
) -> list[float]:
    """Corpus BLEU. hypotheses[i] is a token list; references[i] a list of
    token lists. Returns [BLEU-1, ..., BLEU-max_n]."""
    if len(hypotheses) != len(references):
        raise ValueError("hypotheses and references must align")
    clipped = [0] * max_n  # numerator per order
    totals = [0] * max_n  # denominator per order
    hyp_len = 0
    eff_ref_len = 0
    for hyp, refs in zip(hypotheses, references):
        if not refs:
            raise ValueError("every image needs at least one reference")
        hyp_len += len(hyp)
        # 'closest' ref length; ties -> shorter (pycocoevalcap behaviour).
        eff_ref_len += min(
            (abs(len(r) - len(hyp)), len(r)) for r in refs
        )[1]
        for n in range(1, max_n + 1):
            h_counts = ngram_counts(hyp, n)
            if not h_counts:
                continue
            max_ref: dict = {}
            for r in refs:
                for gram, c in ngram_counts(r, n).items():
                    if c > max_ref.get(gram, 0):
                        max_ref[gram] = c
            totals[n - 1] += sum(h_counts.values())
            clipped[n - 1] += sum(
                min(c, max_ref.get(g, 0)) for g, c in h_counts.items()
            )
    ratio = hyp_len / (eff_ref_len + _TINY)
    bp = 1.0 if ratio > 1.0 else math.exp(1.0 - 1.0 / (ratio + _TINY))
    out = []
    log_sum = 0.0
    for n in range(max_n):
        p_n = (clipped[n] + _TINY) / (totals[n] + _SMALL)
        log_sum += math.log(p_n)
        out.append(bp * math.exp(log_sum / (n + 1)))
    return out
