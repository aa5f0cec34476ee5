"""n-gram counting shared by the scorers (a copy of
``captionkit.metrics.ngrams``)."""

from __future__ import annotations

from collections import Counter
from collections.abc import Sequence


def ngram_counts(tokens: Sequence[str], n: int) -> Counter:
    """Counter of n-grams (as tuples) of exactly order n."""
    return Counter(
        tuple(tokens[i: i + n]) for i in range(len(tokens) - n + 1)
    )


def ngram_counts_upto(tokens: Sequence[str], max_n: int) -> Counter:
    """Counter of all n-grams of order 1..max_n (cider-style cook)."""
    out: Counter = Counter()
    for n in range(1, max_n + 1):
        for i in range(len(tokens) - n + 1):
            out[tuple(tokens[i: i + n])] += 1
    return out
