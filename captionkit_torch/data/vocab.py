"""Vocabulary / wordmap, compatible with the reference's WORDMAP JSON
(a copy of ``captionkit.data.vocab``).

The reference builds a word->id JSON ("WORDMAP_*.json") from COCO train with
a min-frequency threshold (~5) and the special tokens <pad>/<unk>/<start>/
<end>, vocab ≈ 9.5k (SURVEY.md §3.1, ⟦cite⟧ — mount empty). We keep that file
format bit-compatible so reference-prepared data plugs straight in:

* `<pad>` is id 0 (required: padding == zeros everywhere on device).
* `<unk>`, `<start>`, `<end>` follow the content words in reference order.
"""

from __future__ import annotations

import json
from collections import Counter
from collections.abc import Iterable, Sequence

PAD_TOKEN = "<pad>"
UNK_TOKEN = "<unk>"
START_TOKEN = "<start>"
END_TOKEN = "<end>"

# Canonical ids used when *we* build the vocab. When loading a reference
# wordmap the ids come from the file (pad is asserted to be 0).
PAD = 0
UNK = 1
START = 2
END = 3


class Vocab:
    """Word <-> id mapping with reference-compatible JSON round-trip."""

    def __init__(self, word2id: dict[str, int]):
        if word2id.get(PAD_TOKEN, 0) != 0:
            raise ValueError(
                f"{PAD_TOKEN} must map to id 0 (got {word2id.get(PAD_TOKEN)});"
                " device-side masking assumes pad == 0"
            )
        for tok in (UNK_TOKEN, START_TOKEN, END_TOKEN):
            if tok not in word2id:
                raise ValueError(f"vocabulary missing special token {tok}")
        self.word2id = dict(word2id)
        self.id2word = {i: w for w, i in self.word2id.items()}
        if len(self.id2word) != len(self.word2id):
            raise ValueError("wordmap contains duplicate ids")

    # -- construction -------------------------------------------------------

    @classmethod
    def build(
        cls,
        token_seqs: Iterable[Sequence[str]],
        min_freq: int = 5,
    ) -> "Vocab":
        """Build from tokenized captions, reference-style: words with
        frequency >= min_freq, then <unk>, <start>, <end>, with <pad>=0."""
        counts: Counter[str] = Counter()
        for seq in token_seqs:
            counts.update(seq)
        words = sorted(w for w, c in counts.items() if c >= min_freq)
        word2id = {w: i + 1 for i, w in enumerate(words)}  # ids 1..V
        n = len(words)
        word2id[UNK_TOKEN] = n + 1
        word2id[START_TOKEN] = n + 2
        word2id[END_TOKEN] = n + 3
        word2id[PAD_TOKEN] = 0
        return cls(word2id)

    @classmethod
    def load(cls, path: str) -> "Vocab":
        with open(path) as f:
            return cls(json.load(f))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.word2id, f)

    # -- core ops ------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.word2id)

    @property
    def pad(self) -> int:
        return self.word2id[PAD_TOKEN]

    @property
    def unk(self) -> int:
        return self.word2id[UNK_TOKEN]

    @property
    def start(self) -> int:
        return self.word2id[START_TOKEN]

    @property
    def end(self) -> int:
        return self.word2id[END_TOKEN]

    def encode(
        self,
        tokens: Sequence[str],
        max_len: int,
        add_bos_eos: bool = True,
    ) -> tuple[list[int], int]:
        """Map tokens to ids, optionally wrap in <start>..<end>, pad to
        max_len. Returns (ids, true_length) where true_length counts the
        non-pad entries (including <start>/<end>), reference CAPLENS style."""
        ids = [self.word2id.get(t, self.unk) for t in tokens]
        if add_bos_eos:
            budget = max_len - 2
            ids = [self.start] + ids[:budget] + [self.end]
        else:
            ids = ids[:max_len]
        length = len(ids)
        ids = ids + [self.pad] * (max_len - length)
        return ids, length

    def decode(self, ids: Iterable[int], strip_special: bool = True) -> list[str]:
        """Ids -> words. With strip_special, stops at <end> and drops
        <start>/<pad> (the detokenization used by the eval driver,
        SURVEY.md §3.3)."""
        out: list[str] = []
        for i in ids:
            i = int(i)
            if strip_special:
                if i == self.end:
                    break
                if i in (self.pad, self.start):
                    continue
            out.append(self.id2word.get(i, UNK_TOKEN))
        return out

    def decode_to_string(self, ids: Iterable[int]) -> str:
        return " ".join(self.decode(ids))
