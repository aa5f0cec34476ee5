"""ROUGE-L (a copy of ``captionkit.metrics.rouge``), with pycocoevalcap's
semantics: per image the LCS-based F-measure (beta = 1.2) over the
precision and recall each maximized across references; the corpus score
is the mean.
"""

from __future__ import annotations

from collections.abc import Sequence

_BETA = 1.2


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    """Classic O(len(a)*len(b)) LCS length with a rolling row."""
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def _score_image(hyp: Sequence[str], refs: Sequence[Sequence[str]]) -> float:
    """pycocoevalcap semantics: precision and recall are EACH maximized
    independently across references, then combined into one F."""
    if not hyp:
        return 0.0
    prec_max = 0.0
    rec_max = 0.0
    for ref in refs:
        if not ref:
            continue
        lcs = _lcs_len(hyp, ref)
        prec_max = max(prec_max, lcs / len(hyp))
        rec_max = max(rec_max, lcs / len(ref))
    denom = rec_max + _BETA ** 2 * prec_max
    if denom == 0.0:
        return 0.0
    return ((1 + _BETA ** 2) * prec_max * rec_max) / denom


def rouge_l(
    hypotheses: Sequence[Sequence[str]],
    references: Sequence[Sequence[Sequence[str]]],
) -> float:
    if len(hypotheses) != len(references):
        raise ValueError("hypotheses and references must align")
    total = 0.0
    for hyp, refs in zip(hypotheses, references):
        total += _score_image(hyp, refs)
    return total / max(len(hypotheses), 1)
