"""Offline data preparation (a copy of ``captionkit.data.prepare``):
Karpathy-split JSON + bottom-up features + existing-caption JSON -> the
on-disk artifacts the rest of the package reads (wordmap JSON, encoded
caption/caplen JSONs, per-split feature .npy). Given the same inputs and
seed it writes the same bytes as the reference.

Formats:
* Karpathy JSON: {"images": [{"split": "train|val|test|restval",
  "sentences": [{"tokens": [...]}, ...], "cocoid"|"imgid": int,
  "filename": str}]}
* Existing captions: [{"image_id": int, "caption": str}] (AoANet output
  format) or {"<image_id>": "caption"}.
* Features: a .npy of [N_images, R, F] in the split's image order.

Conventions: captions_per_image enforced by sampling (with replacement
when an image has fewer references, from ``random.Random(seed)``); words
below min_word_freq become <unk>; training targets longer than
max_len - 2 are skipped (existing captions are truncated, since every
image needs one). The wordmap is built from the train split only.
"""

from __future__ import annotations

import json
import os
import random
from collections import defaultdict
from dataclasses import dataclass
from typing import Optional

import numpy as np

from captionkit_torch.data.tokenize import simple_tokenize
from captionkit_torch.data.vocab import Vocab

SPLIT_MAP = {"train": "train", "restval": "train", "val": "val",
             "test": "test"}


@dataclass
class PreparedSplit:
    captions_path: str
    caplens_path: str
    existing_path: str
    existing_caplens_path: str
    features_path: str
    image_ids_path: str
    refs_path: str


def _load_existing_captions(path: str) -> dict[int, str]:
    with open(path) as f:
        raw = json.load(f)
    if isinstance(raw, dict):
        return {int(k): v for k, v in raw.items()}
    return {int(d["image_id"]): d["caption"] for d in raw}


def prepare_from_karpathy(
    *,
    karpathy_json: str,
    output_dir: str,
    existing_captions: dict[str, str],  # split -> AoANet caption JSON path
    features: Optional[dict[str, str]] = None,  # split -> [N,R,F] array path
    min_word_freq: int = 5,
    max_len: int = 22,
    captions_per_image: int = 5,
    seed: int = 0,
) -> dict[str, PreparedSplit]:
    """Produce reference-format artifacts. Returns per-split file paths."""
    os.makedirs(output_dir, exist_ok=True)
    rng = random.Random(seed)
    with open(karpathy_json) as f:
        blob = json.load(f)

    per_split: dict[str, list[dict]] = defaultdict(list)
    for img in blob["images"]:
        split = SPLIT_MAP.get(img.get("split", "train"))
        if split is None:
            continue
        per_split[split].append(img)

    # Wordmap from train captions only (reference behaviour).
    train_tokens = [
        s["tokens"]
        for img in per_split["train"]
        for s in img["sentences"]
    ]
    vocab = Vocab.build(train_tokens, min_freq=min_word_freq)
    wordmap_path = os.path.join(output_dir, "WORDMAP.json")
    vocab.save(wordmap_path)

    out: dict[str, PreparedSplit] = {}
    for split, images in sorted(per_split.items()):
        existing_by_id = _load_existing_captions(existing_captions[split])
        enc_caps: list[list[int]] = []
        caplens: list[int] = []
        enc_exist: list[list[int]] = []
        exist_lens: list[int] = []
        image_ids: list[int] = []
        refs: dict[int, list[list[str]]] = {}

        for row, img in enumerate(images):
            img_id = int(img.get("cocoid", img.get("imgid")))
            sents = [s["tokens"] for s in img["sentences"]]
            usable = [t for t in sents if len(t) <= max_len - 2]
            if not usable:
                usable = [sents[0][: max_len - 2]]
            refs[img_id] = sents
            if len(usable) >= captions_per_image:
                chosen = rng.sample(usable, captions_per_image)
            else:
                chosen = usable + [
                    rng.choice(usable)
                    for _ in range(captions_per_image - len(usable))
                ]
            if img_id not in existing_by_id:
                raise KeyError(
                    f"no existing (AoANet) caption for image {img_id} "
                    f"in split {split!r}"
                )
            exist_tokens = simple_tokenize(existing_by_id[img_id])
            e_ids, e_len = vocab.encode(exist_tokens, max_len)
            for cap in chosen:
                c_ids, c_len = vocab.encode(cap, max_len)
                enc_caps.append(c_ids)
                caplens.append(c_len)
                enc_exist.append(e_ids)
                exist_lens.append(e_len)
                image_ids.append(img_id)

        def _dump(name: str, obj) -> str:
            path = os.path.join(output_dir, f"{split.upper()}_{name}.json")
            with open(path, "w") as f:
                json.dump(obj, f)
            return path

        paths = PreparedSplit(
            captions_path=_dump("CAPTIONS", enc_caps),
            caplens_path=_dump("CAPLENS", caplens),
            existing_path=_dump("EXISTING", enc_exist),
            existing_caplens_path=_dump("EXISTING_CAPLENS", exist_lens),
            features_path="",
            image_ids_path=_dump("IMAGE_IDS", image_ids),
            refs_path=_dump(
                "REFS", {str(k): v for k, v in refs.items()}
            ),
        )
        if features and split in features:
            src = np.load(features[split], mmap_mode="r")
            if src.shape[0] != len(images):
                raise ValueError(
                    f"features for {split} have {src.shape[0]} rows, "
                    f"expected {len(images)} images"
                )
            # Stored per image (caption rows are image-major with exactly
            # captions_per_image rows each; CaptionDataset rebuilds the
            # row->image mapping from that ratio). Copied in chunks so a
            # COCO-scale array never sits in memory whole.
            dst = os.path.join(output_dir, f"{split.upper()}_FEATURES.npy")
            out_mm = np.lib.format.open_memmap(
                dst, mode="w+", dtype=src.dtype, shape=src.shape
            )
            chunk = 1024
            for lo in range(0, src.shape[0], chunk):
                out_mm[lo: lo + chunk] = src[lo: lo + chunk]
            out_mm.flush()
            del out_mm
            paths.features_path = dst
        out[split] = paths

    with open(os.path.join(output_dir, "PREP_MANIFEST.json"), "w") as f:
        json.dump(
            {
                "wordmap": wordmap_path,
                "vocab_size": len(vocab),
                "max_len": max_len,
                "captions_per_image": captions_per_image,
                "splits": {
                    k: v.__dict__ for k, v in out.items()
                },
            },
            f, indent=2,
        )
    return out


def load_prepared_split(
    output_dir: str, split: str, *, max_len: Optional[int] = None
):
    """Load artifacts written by prepare_from_karpathy into a
    CaptionDataset (with references attached for metrics/SCST)."""
    from captionkit_torch.data.sources import CaptionDataset

    with open(os.path.join(output_dir, "PREP_MANIFEST.json")) as f:
        manifest = json.load(f)
    paths = manifest["splits"][split]
    ds = CaptionDataset.from_reference_files(
        wordmap_path=manifest["wordmap"],
        captions_path=paths["captions_path"],
        caplens_path=paths["caplens_path"],
        existing_captions_path=paths["existing_path"],
        existing_caplens_path=paths["existing_caplens_path"],
        features_path=paths["features_path"],
        max_len=max_len or manifest["max_len"],
    )
    with open(paths["image_ids_path"]) as f:
        image_ids = json.load(f)
    with open(paths["refs_path"]) as f:
        refs_by_id = json.load(f)
    # Rows are image-major with captions_per_image rows per image; rebuild
    # image_index against the dense per-split image order.
    uniq: list[int] = []
    seen = set()
    for i in image_ids:
        if i not in seen:
            seen.add(i)
            uniq.append(i)
    id_to_dense = {img: d for d, img in enumerate(uniq)}
    ds.image_index = np.asarray(
        [id_to_dense[i] for i in image_ids], np.int32
    )
    ds.references = [refs_by_id[str(i)] for i in uniq]
    ds.image_ids = np.asarray(uniq, np.int64)
    return ds
