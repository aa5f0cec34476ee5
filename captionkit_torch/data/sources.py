"""Data sources (a copy of ``captionkit.data.sources``): the reader of the
reference's on-disk split artifacts, an in-memory split and the synthetic
source.

``load_hdf5_features`` opens a split's [N, R, F] features: ``.npy``
through ``FeatureStore`` (threaded native row gather; numpy's for a
layout the native gather cannot read), ``.npz``
read whole, HDF5 through h5py (optional; absent, it raises).

``SyntheticCaptionSource`` draws from ``np.random.default_rng(seed)`` in
the same order as the reference, so the same seed gives the same vocab,
captions and features on both sides.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import numpy as np

from captionkit_torch.data.pipeline import (
    Batch,
    encode_captions,
    make_batches,
    take_rows,
)
from captionkit_torch.data.vocab import Vocab


def load_hdf5_features(path: str, dataset: str = "features"):
    """[N, R, F] features of a split: a ``.npy`` through ``FeatureStore``
    (the native gather, or numpy's for a layout the native one cannot
    read), the ``dataset`` array of a ``.npz``, else the
    ``dataset`` of an HDF5 file (needs h5py)."""
    if path.endswith(".npy"):
        from captionkit_torch.data.faststore import FeatureStore

        return FeatureStore(path)
    if path.endswith(".npz"):
        return np.load(path)[dataset]
    try:
        import h5py  # type: ignore
    except ImportError as e:
        raise ImportError(
            "h5py is required for HDF5 feature files; convert to .npy instead"
        ) from e
    f = h5py.File(path, "r")
    return f[dataset]


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

    @classmethod
    def from_reference_files(
        cls,
        *,
        wordmap_path: str,
        captions_path: str,
        caplens_path: str,
        existing_captions_path: str,
        existing_caplens_path: str,
        features_path: str = "",
        max_len: int = 22,
        captions_per_image: Optional[int] = None,
    ) -> "CaptionDataset":
        """Read reference-prepared JSON artifacts and features. Caption
        rows are image-major, ``captions_per_image`` an image (derived from
        the features' row count when not given); each image's references
        are rebuilt from its GT rows."""
        vocab = Vocab.load(wordmap_path)

        def _load_ids(p: str) -> np.ndarray:
            with open(p) as f:
                rows = json.load(f)
            out = np.zeros((len(rows), max_len), dtype=np.int32)
            for i, row in enumerate(rows):
                n = min(len(row), max_len)
                out[i, :n] = row[:n]
            return out

        def _load_lens(p: str) -> np.ndarray:
            with open(p) as f:
                return np.asarray(json.load(f), dtype=np.int32).reshape(-1)

        target = _load_ids(captions_path)
        target_len = np.minimum(_load_lens(caplens_path), max_len)
        existing = _load_ids(existing_captions_path)
        existing_len = np.minimum(_load_lens(existing_caplens_path), max_len)
        features = (
            load_hdf5_features(features_path) if features_path else None)
        n = existing.shape[0]
        n_img = n if features is None else features.shape[0]
        # Without a features file the image count is not derivable from
        # the artifacts: pass captions_per_image then.
        cpi = captions_per_image or max(1, n // max(1, n_img))
        image_index = np.arange(n, dtype=np.int32) // cpi
        references: list[list[list[str]]] = [
            [] for _ in range(int(image_index[-1]) + 1 if n else 0)]
        for row, img in enumerate(image_index):
            references[int(img)].append(vocab.decode(target[row]))
        return cls(
            features=features,
            existing=existing,
            existing_len=existing_len,
            target=target,
            target_len=target_len,
            image_index=image_index,
            vocab=vocab,
            references=references,
        )

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

    def shard(self, num_shards: int, index: int) -> "CaptionDataset":
        """Rows ``index::num_shards`` (round-robin, so caption lengths stay
        spread evenly over the shards). Features, references and image ids
        are shared, not copied. Shard ``eval_view()`` to split a decode
        over processes: each results file keys by the real image ids, so
        the shards' files concatenate."""
        if not 0 <= index < num_shards:
            raise ValueError(
                f"shard index {index} outside [0, {num_shards})")
        sel = np.arange(index, self.size, num_shards)
        return CaptionDataset(
            features=self.features,
            existing=self.existing[sel],
            existing_len=self.existing_len[sel],
            target=None if self.target is None else self.target[sel],
            target_len=(None if self.target_len is None
                        else self.target_len[sel]),
            image_index=self.image_index[sel],
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
        share: Optional[tuple[int, int]] = None,
        feature_out: Optional[Callable[[], np.ndarray]] = None,
    ) -> Iterator[Batch]:
        """``make_batches`` over the split; ``share=(r, W)`` yields the
        r-th 1/W of every batch's rows and gathers only their features.
        ``feature_out``: each batch's features are gathered straight into
        the array it returns (``make_batches``), with no fresh array in
        between."""
        features = None
        if self.features is not None:
            source = self.features
            image_index = self.image_index

            def features(idx, out=None, _src=source, _map=image_index):
                rows = _map[idx]
                if hasattr(_src, "gather"):
                    return _src.gather(rows, out=out)
                if isinstance(_src, np.ndarray):
                    return _src[rows] if out is None else take_rows(
                        _src, rows, out)
                # An h5py dataset takes sorted unique indices: read those
                # rows once and scatter them back in the batch's order.
                order = np.argsort(rows, kind="stable")
                uniq, inverse = np.unique(rows[order], return_inverse=True)
                block = _src[uniq]
                if out is None:
                    out = np.empty((len(rows), *block.shape[1:]),
                                   block.dtype)
                out[order] = block[inverse]
                return out

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
            share=share,
            feature_out=feature_out,
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
