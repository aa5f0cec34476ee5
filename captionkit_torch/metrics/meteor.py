"""METEOR-lite (a copy of ``captionkit.metrics.meteor``): an in-process,
pure-Python METEOR approximation for hosts without the METEOR 1.5 jar
and a JVM (``metrics.external``). The classic METEOR formulation (Lavie &
Agarwal 2007) with the **exact** and **Porter-stem** matcher stages.

What "lite" means, precisely:

- No WordNet synonym stage and no paraphrase-table stage, and none of
  METEOR 1.5's tuned module weights or function-word discounting. Scores
  sit below the jar's on the same captions (fewer matches found), so the
  evaluator reports it under the key ``METEOR-lite``, never ``METEOR``,
  which stays reserved for the jar.
- The alignment is the deterministic greedy of NLTK's ``meteor_score``
  (hypothesis scanned in reverse, each word taking the highest still-unused
  reference position of the same surface form or stem), not METEOR's
  chunk-minimizing search: the segment score equals
  ``nltk.translate.meteor_score`` restricted to its exact and stem stages.

The Porter stemmer is nltk's, imported at first use; without nltk the
evaluator leaves the metric out.

Segment score (alpha=0.9, beta=3, gamma=0.5, the 2007 defaults):

    P = m / |h|;  R = m / |r|;  Fmean = P*R / (alpha*P + (1-alpha)*R)
    penalty = gamma * (chunks / m) ** beta;  score = Fmean * (1 - penalty)

Corpus score: per segment the best-scoring reference's (m, |h|, |r|,
chunks) are summed over the corpus and the formula is applied once to the
sums, which weights long captions more than a plain mean of segment
scores would. Both are returned.
"""

from __future__ import annotations

from collections import defaultdict
from collections.abc import Mapping, Sequence
from dataclasses import dataclass
from functools import lru_cache

ALPHA = 0.9
BETA = 3.0
GAMMA = 0.5


@lru_cache(maxsize=65536)
def _stem(word: str) -> str:
    return _stemmer().stem(word)


@lru_cache(maxsize=1)
def _stemmer():
    from nltk.stem.porter import PorterStemmer

    return PorterStemmer()


def _greedy_stage(
    hyp: list[tuple[int, str]], ref: list[tuple[int, str]]
) -> tuple[list[tuple[int, int]], list[tuple[int, str]], list[tuple[int, str]]]:
    """One matcher stage: hypothesis scanned in reverse order, each word
    matched to the highest still-unused reference position with the same
    (already surface- or stem-mapped) token. Returns (matches as original
    (hyp_idx, ref_idx) pairs, unmatched hyp, unmatched ref)."""
    positions: dict[str, list[int]] = defaultdict(list)
    for j, (_, w) in enumerate(ref):
        positions[w].append(j)
    matches: list[tuple[int, int]] = []
    used_h: set[int] = set()
    used_r: set[int] = set()
    for i in range(len(hyp) - 1, -1, -1):
        avail = positions.get(hyp[i][1])
        if avail:
            j = avail.pop()
            used_h.add(i)
            used_r.add(j)
            matches.append((hyp[i][0], ref[j][0]))
    rest_h = [p for i, p in enumerate(hyp) if i not in used_h]
    rest_r = [p for j, p in enumerate(ref) if j not in used_r]
    return matches, rest_h, rest_r


def _align(hyp_tokens: Sequence[str], ref_tokens: Sequence[str]):
    """Exact stage then stem stage over the leftovers; matches sorted by
    hypothesis index (chunk counting depends on that order)."""
    hyp = [(i, w.lower()) for i, w in enumerate(hyp_tokens)]
    ref = [(j, w.lower()) for j, w in enumerate(ref_tokens)]
    exact, hyp, ref = _greedy_stage(hyp, ref)
    stem, _, _ = _greedy_stage(
        [(i, _stem(w)) for i, w in hyp], [(j, _stem(w)) for j, w in ref]
    )
    return sorted(exact + stem)


def _count_chunks(matches: list[tuple[int, int]]) -> int:
    chunks = 1
    for a, b in zip(matches, matches[1:]):
        if not (b[0] == a[0] + 1 and b[1] == a[1] + 1):
            chunks += 1
    return chunks


@dataclass(frozen=True)
class SegmentStats:
    matches: int
    hyp_len: int
    ref_len: int
    chunks: int

    @property
    def score(self) -> float:
        return _formula(self.matches, self.hyp_len, self.ref_len, self.chunks)


def _formula(m: int, hlen: int, rlen: int, chunks: int) -> float:
    if m == 0 or hlen == 0 or rlen == 0:
        return 0.0
    p = m / hlen
    r = m / rlen
    fmean = p * r / (ALPHA * p + (1 - ALPHA) * r)
    penalty = GAMMA * (chunks / m) ** BETA
    return fmean * (1 - penalty)


def segment_stats(
    hyp_tokens: Sequence[str], ref_tokens: Sequence[str]
) -> SegmentStats:
    matches = _align(hyp_tokens, ref_tokens)
    return SegmentStats(
        matches=len(matches),
        hyp_len=len(list(hyp_tokens)),
        ref_len=len(list(ref_tokens)),
        chunks=_count_chunks(matches) if matches else 0,
    )


def meteor_lite_segment(
    hyp_tokens: Sequence[str], refs_tokens: Sequence[Sequence[str]]
) -> tuple[float, SegmentStats]:
    """Score one hypothesis against multiple references: the best-scoring
    reference wins (NLTK/METEOR multi-reference semantics)."""
    best: SegmentStats | None = None
    for ref in refs_tokens:
        st = segment_stats(hyp_tokens, ref)
        if best is None or st.score > best.score:
            best = st
    assert best is not None, "at least one reference required"
    return best.score, best


def meteor_lite(
    hyp_tok: Sequence[Sequence[str]],
    refs_tok: Sequence[Sequence[Sequence[str]]],
) -> tuple[float, list[float]]:
    """Corpus METEOR-lite over pre-tokenized captions.

    Returns (corpus score from summed best-reference statistics, per-segment
    scores). Inputs mirror the other captionkit scorers: hyp_tok[i] is a
    token list, refs_tok[i] a list of token lists.
    """
    if len(hyp_tok) != len(refs_tok):
        raise ValueError("hypothesis/reference count mismatch")
    per = []
    m = hlen = rlen = chunks = 0
    for hyp, refs in zip(hyp_tok, refs_tok):
        score, st = meteor_lite_segment(hyp, refs)
        per.append(score)
        m += st.matches
        hlen += st.hyp_len
        rlen += st.ref_len
        chunks += st.chunks
    return _formula(m, hlen, rlen, chunks), per


def meteor_lite_score(
    references: Mapping[object, Sequence[str]],
    hypotheses: Mapping[object, str],
) -> float:
    """String-level convenience with the evaluator's calling convention
    (PTB-tokenized like every other captionkit scorer)."""
    from captionkit_torch.data.tokenize import ptb_tokenize

    ids = sorted(hypotheses.keys(), key=str)
    hyp_tok = [ptb_tokenize(hypotheses[i]) for i in ids]
    refs_tok = [[ptb_tokenize(r) for r in references[i]] for i in ids]
    corpus, _ = meteor_lite(hyp_tok, refs_tok)
    return corpus
