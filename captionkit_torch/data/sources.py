"""Data sources: an in-memory split and the synthetic source (copies of
the parts of ``captionkit.data.sources`` that serving uses).

``SyntheticCaptionSource`` draws from ``np.random.default_rng(seed)`` in
the same order as the reference, so the same seed gives the same vocab,
captions and features on both sides.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from captionkit_torch.data.pipeline import Batch, encode_captions, make_batches
from captionkit_torch.data.vocab import Vocab


@dataclass
class CaptionDataset:
    """A split of (features, existing caption, target caption) triples,
    exposed as static-shape batches."""

    features: Optional[np.ndarray]  # [N_img, R, F] or None (text-only)
    existing: np.ndarray  # [N, L_in] int32
    existing_len: np.ndarray  # [N]
    target: Optional[np.ndarray]  # [N, L_out] int32 (None at pure eval)
    target_len: Optional[np.ndarray]
    image_index: np.ndarray  # [N] int32: row -> image
    vocab: Vocab
    references: Optional[list[list[list[str]]]] = None
    image_ids: Optional[np.ndarray] = None  # [N_img] original ids

    @property
    def size(self) -> int:
        return int(self.existing.shape[0])

    def eval_view(self) -> "CaptionDataset":
        """One row per image (the first caption row): the decode layout."""
        first = np.unique(self.image_index, return_index=True)[1]
        return CaptionDataset(
            features=self.features,
            existing=self.existing[first],
            existing_len=self.existing_len[first],
            target=None,
            target_len=None,
            image_index=self.image_index[first],
            vocab=self.vocab,
            references=self.references,
            image_ids=self.image_ids,
        )

    def batches(
        self,
        batch_size: int,
        *,
        shuffle: bool = False,
        seed: int = 0,
        drop_remainder: bool = False,
        feat_shape: tuple[int, int] = (36, 2048),
    ) -> Iterator[Batch]:
        features = None
        if self.features is not None:
            source = self.features
            image_index = self.image_index

            def features(idx, _src=source, _map=image_index):
                return _src[_map[idx]]

        return make_batches(
            features=features,
            existing=self.existing,
            existing_len=self.existing_len,
            target=self.target,
            target_len=self.target_len,
            image_id=self.image_index,
            batch_size=batch_size,
            shuffle=shuffle,
            seed=seed,
            drop_remainder=drop_remainder,
            feat_shape=feat_shape,
        )


# --------------------------------------------------------------------------
# Synthetic data (tests and smoke runs without COCO on disk)
# --------------------------------------------------------------------------

_SUBJECTS = ["a man", "a woman", "a dog", "a cat", "two people", "a child",
             "a group of people", "a bird", "a horse", "an elephant"]
_VERBS = ["riding", "holding", "watching", "standing near", "sitting on",
          "playing with", "walking past", "looking at", "jumping over"]
_OBJECTS = ["a skateboard", "a red umbrella", "the beach", "a wooden bench",
            "a plate of food", "a blue train", "the grass", "a laptop",
            "a baseball bat", "a slice of pizza"]
_TAILS = ["", "in the park", "on a sunny day", "at night", "next to a tree",
          "in the city", "under a bridge"]


def _toy_caption(rng: np.random.Generator) -> list[str]:
    parts = [
        _SUBJECTS[rng.integers(len(_SUBJECTS))],
        _VERBS[rng.integers(len(_VERBS))],
        _OBJECTS[rng.integers(len(_OBJECTS))],
        _TAILS[rng.integers(len(_TAILS))],
    ]
    return " ".join(p for p in parts if p).split()


def _corrupt(tokens: list[str], rng: np.random.Generator) -> list[str]:
    """Make an 'existing caption': drop/substitute a word."""
    toks = list(tokens)
    if len(toks) > 3 and rng.random() < 0.5:
        del toks[rng.integers(len(toks))]
    if toks and rng.random() < 0.5:
        j = int(rng.integers(len(toks)))
        toks[j] = _OBJECTS[rng.integers(len(_OBJECTS))].split()[-1]
    return toks


class SyntheticCaptionSource:
    """Deterministic fake COCO: toy-grammar captions + random features."""

    def __init__(
        self,
        num_images: int = 128,
        captions_per_image: int = 5,
        num_regions: int = 36,
        feat_dim: int = 2048,
        max_len: int = 22,
        seed: int = 0,
        with_features: bool = True,
    ):
        rng = np.random.default_rng(seed)
        self.max_len = max_len
        gts: list[list[list[str]]] = []
        target_tokens: list[list[str]] = []
        existing_tokens: list[list[str]] = []
        image_index: list[int] = []
        for img in range(num_images):
            refs = [_toy_caption(rng) for _ in range(captions_per_image)]
            gts.append(refs)
            for r in refs:
                target_tokens.append(r)
                existing_tokens.append(_corrupt(refs[0], rng))
                image_index.append(img)
        self.vocab = Vocab.build(target_tokens + existing_tokens, min_freq=1)
        target, target_len = encode_captions(target_tokens, self.vocab, max_len)
        existing, existing_len = encode_captions(
            existing_tokens, self.vocab, max_len)
        features = None
        if with_features:
            features = rng.standard_normal(
                (num_images, num_regions, feat_dim), dtype=np.float32)
        self.dataset = CaptionDataset(
            features=features,
            existing=existing,
            existing_len=existing_len,
            target=target,
            target_len=target_len,
            image_index=np.asarray(image_index, dtype=np.int32),
            vocab=self.vocab,
            references=gts,
        )

    def eval_view(self) -> CaptionDataset:
        """One row per image (first existing caption), for decode eval."""
        return self.dataset.eval_view()
