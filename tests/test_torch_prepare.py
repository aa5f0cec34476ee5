"""The port's split loading and preparation (``captionkit_torch.data``:
``prepare``, ``sources``, ``pipeline``, ``faststore``) against
``captionkit.data`` on the same files.

``prepare_from_karpathy`` must write byte-identical artifacts (the
manifest, which records the output paths, after swapping the directory);
the datasets the two packages load from them, their shards and their
(bucketed) batches must be equal; the native ``FeatureStore`` gather must
be byte-equal to the numpy gather.
"""

import contextlib
import io
import json

import numpy as np
import pytest

from captionkit.data import pipeline as jpipeline
from captionkit.data.prepare import load_prepared_split as j_load_prepared
from captionkit.data.prepare import prepare_from_karpathy as j_prepare
from captionkit.data.sources import CaptionDataset as JDataset
from captionkit.data.sources import load_hdf5_features as j_load_features

from captionkit_torch import cli
from captionkit_torch.data import pipeline
from captionkit_torch.data.faststore import FeatureStore
from captionkit_torch.data.prepare import load_prepared_split
from captionkit_torch.data.sources import CaptionDataset, load_hdf5_features

R, F = 4, 8
SENTS = ["a man rides a horse", "a dog runs in the park",
         "two people sit on a bench", "a cat sleeps on the couch",
         "a bird flies over the water", "a child eats a slice of pizza",
         "an old man with a very long beard walks his small dog along "
         "the wide and sunny beach in the morning light"]


def _karpathy(tmp_path, n=(5, 2, 7)):
    """Karpathy JSON (train, restval, val, test; 1 to 6 sentences an image,
    one over the length cap), existing-caption JSONs in both formats, and
    features per split."""
    rng = np.random.default_rng(0)
    images, existing = [], {"train": [], "val": {}, "test": []}
    img_id = 9000
    for split, count in (("train", n[0]), ("restval", 1), ("val", n[1]),
                         ("test", n[2])):
        for _ in range(count):
            caps = [SENTS[rng.integers(len(SENTS))].split()
                    for _ in range(int(rng.integers(1, 7)))]
            images.append({"split": split, "cocoid": img_id,
                           "filename": f"{img_id}.jpg",
                           "sentences": [{"tokens": c} for c in caps]})
            key = "train" if split in ("train", "restval") else split
            cap = " ".join(caps[0][:-1]) + " zebra"
            if key == "val":
                existing[key][str(img_id)] = cap
            else:
                existing[key].append({"image_id": img_id, "caption": cap})
            img_id += 7
    kpath = tmp_path / "karpathy.json"
    kpath.write_text(json.dumps({"images": images, "dataset": "coco"}))
    epaths, fpaths = {}, {}
    for split, rows in existing.items():
        epaths[split] = str(tmp_path / f"existing_{split}.json")
        (tmp_path / f"existing_{split}.json").write_text(json.dumps(rows))
    for split, count in (("train", n[0] + 1), ("val", n[1]), ("test", n[2])):
        fpaths[split] = str(tmp_path / f"feats_{split}.npy")
        np.save(fpaths[split],
                rng.standard_normal((count, R, F)).astype(np.float32))
    return str(kpath), epaths, fpaths


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """The reference's prepare into ``ref/``, the port's CLI into
    ``port/``, from the same inputs."""
    tmp = tmp_path_factory.mktemp("prep")
    kpath, epaths, fpaths = _karpathy(tmp)
    kw = dict(min_word_freq=2, max_len=12, captions_per_image=3)
    j_prepare(karpathy_json=kpath, output_dir=str(tmp / "ref"),
              existing_captions=epaths, features=fpaths, **kw)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main([
            "prepare", "--karpathy", kpath, "--out", str(tmp / "port"),
            *[a for s, p in epaths.items()
              for a in ("--existing", f"{s}={p}")],
            *[a for s, p in fpaths.items()
              for a in ("--features", f"{s}={p}")],
            "--min-word-freq", "2", "--max-len", "12",
            "--captions-per-image", "3"]) == 0
    (tmp / "printed.json").write_text(out.getvalue())
    return tmp


def test_prepare_artifacts_byte_identical(prepared):
    ref, port = prepared / "ref", prepared / "port"
    names = sorted(p.name for p in ref.iterdir())
    assert names == sorted(p.name for p in port.iterdir())
    assert "TEST_FEATURES.npy" in names and "WORDMAP.json" in names
    for name in names:
        want = (ref / name).read_bytes()
        if name == "PREP_MANIFEST.json":
            want = want.replace(str(ref).encode(), str(port).encode())
        assert (port / name).read_bytes() == want, name
    printed = json.loads((prepared / "printed.json").read_text())
    assert sorted(printed) == ["test", "train", "val"]
    assert printed["test"]["features_path"] == str(port /
                                                    "TEST_FEATURES.npy")


def _assert_datasets_equal(t, j):
    for f in ("existing", "existing_len", "target", "target_len",
              "image_index", "image_ids"):
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
            assert a.dtype == b.dtype, f
    assert t.references == j.references
    assert t.vocab.word2id == j.vocab.word2id
    if j.features is not None:
        rows = np.arange(len(j.features))[::-1]
        np.testing.assert_array_equal(t.features.gather(rows),
                                      j.features.gather(rows))


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_load_prepared_split_equal(prepared, split):
    t = load_prepared_split(str(prepared / "port"), split)
    j = j_load_prepared(str(prepared / "ref"), split)
    _assert_datasets_equal(t, j)
    assert t.features.is_native
    _assert_datasets_equal(t.eval_view(), j.eval_view())
    assert load_prepared_split(str(prepared / "port"), split,
                               max_len=9).existing.shape[1] == 9


def _raw_files(prepared, split="test"):
    d = prepared / "ref"
    return dict(
        wordmap_path=str(d / "WORDMAP.json"),
        captions_path=str(d / f"{split.upper()}_CAPTIONS.json"),
        caplens_path=str(d / f"{split.upper()}_CAPLENS.json"),
        existing_captions_path=str(d / f"{split.upper()}_EXISTING.json"),
        existing_caplens_path=str(
            d / f"{split.upper()}_EXISTING_CAPLENS.json"))


@pytest.mark.parametrize("kw", [
    {"with_features": True},
    {"with_features": False, "captions_per_image": 3},
    {"with_features": True, "max_len": 8},
])
def test_from_reference_files_equal(prepared, kw):
    kw = dict(kw)
    files = _raw_files(prepared)
    if kw.pop("with_features"):
        files["features_path"] = str(prepared / "ref" / "TEST_FEATURES.npy")
    t = CaptionDataset.from_reference_files(**files, **kw)
    j = JDataset.from_reference_files(**files, **kw)
    _assert_datasets_equal(t, j)
    assert len(t.references) == 7 and t.image_ids is None


@pytest.mark.parametrize("num_shards,index", [(1, 0), (2, 0), (2, 1),
                                              (3, 2), (8, 7)])
def test_shard_equal(prepared, num_shards, index):
    t = load_prepared_split(str(prepared / "port"), "train")
    j = j_load_prepared(str(prepared / "ref"), "train")
    for a, b in ((t, j), (t.eval_view(), j.eval_view())):
        _assert_datasets_equal(a.shard(num_shards, index),
                               b.shard(num_shards, index))
    with pytest.raises(ValueError, match="shard index"):
        t.shard(num_shards, num_shards)


def _assert_batches_equal(tb, jb):
    tb, jb = list(tb), list(jb)
    assert len(tb) == len(jb)
    for a, b in zip(tb, jb):
        for f in ("features", "existing", "existing_len", "target",
                  "target_len", "valid", "image_id"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                np.testing.assert_array_equal(x, y, err_msg=f)
                assert x.shape == y.shape and x.dtype == y.dtype, f


@pytest.mark.parametrize("boundaries", [(4, 8), (3, 6, 9, 30), (20,)])
def test_bucket_batches_and_length_mask_equal(prepared, boundaries):
    t = load_prepared_split(str(prepared / "port"), "train")
    j = j_load_prepared(str(prepared / "ref"), "train")
    for kw in ({}, {"shuffle": True, "seed": 3}):
        _assert_batches_equal(
            pipeline.bucket_batches(t.batches(4, feat_shape=(R, F), **kw),
                                    boundaries),
            jpipeline.bucket_batches(j.batches(4, feat_shape=(R, F), **kw),
                                     boundaries))
    lens = t.existing_len
    np.testing.assert_array_equal(pipeline.length_mask(lens, 12),
                                  jpipeline.length_mask(lens, 12))


@pytest.mark.parametrize("suffix", [".npy", ".npz", ".h5"])
def test_load_features_and_batches_equal(tmp_path, suffix):
    """Each format loads the same rows, and a dataset over it gathers the
    same batches (rows repeated and out of order: the HDF5 path reads
    sorted unique rows and scatters them back)."""
    arr = np.random.default_rng(1).standard_normal((6, R, F)).astype(
        np.float32)
    path = str(tmp_path / f"feats{suffix}")
    if suffix == ".npy":
        np.save(path, arr)
    elif suffix == ".npz":
        np.savez(path, features=arr)
    else:
        h5py = pytest.importorskip("h5py")
        with h5py.File(path, "w") as f:
            f["features"] = arr
    t, j = load_hdf5_features(path), j_load_features(path)
    np.testing.assert_array_equal(np.asarray(t[np.arange(6)]), arr)
    np.testing.assert_array_equal(np.asarray(t[np.arange(6)]),
                                  np.asarray(j[np.arange(6)]))
    if suffix == ".npy":
        assert t.is_native
    image_index = np.asarray([5, 0, 3, 3, 1, 5, 2, 0, 4], np.int32)
    rng = np.random.default_rng(2)
    ex = rng.integers(4, 9, (9, 10)).astype(np.int32)
    ln = rng.integers(1, 11, (9,)).astype(np.int32)
    common = dict(existing=ex, existing_len=ln, target=None,
                  target_len=None, image_index=image_index, vocab=None)
    _assert_batches_equal(
        CaptionDataset(features=t, **common).batches(4, feat_shape=(R, F)),
        JDataset(features=j, **common).batches(4, feat_shape=(R, F)))


@pytest.mark.parametrize("idx", [
    [0, 1, 2, 3], [63, 5, 17, 0, 40], [5, 5, 5, 63, 5, 0], list(range(64))
    + list(range(63, -1, -1))])
def test_feature_store_native_byte_equal_to_numpy(tmp_path, idx):
    arr = np.random.default_rng(0).standard_normal((64, R, 16)).astype(
        np.float32)
    path = str(tmp_path / "f.npy")
    np.save(path, arr)
    native, plain = FeatureStore(path), FeatureStore(path, native=False)
    assert native.is_native and not plain.is_native
    got = native.gather(np.asarray(idx))
    assert got.tobytes() == plain.gather(np.asarray(idx)).tobytes()
    assert got.tobytes() == arr[idx].tobytes()
    with pytest.raises(IndexError):
        native.gather([64])
    native.close()
    with pytest.raises(ValueError, match="closed"):
        native.gather([0])


def test_feature_store_rejects_what_the_native_gather_does_not_take(
        tmp_path):
    """A layout the native gather cannot read (float64, Fortran order,
    big-endian) goes to the numpy gather, chosen from the header."""
    arr = np.arange(24, dtype=np.float64).reshape(4, 2, 3)
    for name, a in (("f64", arr), ("fortran", np.asfortranarray(
            arr.astype(np.float32))), ("big", arr.astype(">f4"))):
        path = str(tmp_path / f"{name}.npy")
        np.save(path, a)
        store = FeatureStore(path)
        assert not store.is_native, name
        np.testing.assert_array_equal(store.gather([3, 0]), a[[3, 0]])
        np.testing.assert_array_equal(
            FeatureStore(path, native=False).gather([3, 0]), a[[3, 0]])


class _SortedOnly:
    """An h5py-like source: rows read only at sorted unique indices."""

    def __init__(self, arr):
        self._arr, self.shape, self.dtype = arr, arr.shape, arr.dtype

    def __getitem__(self, idx):
        idx = np.asarray(idx)
        if np.any(np.diff(idx) <= 0):
            raise TypeError("indices must be sorted and unique")
        if idx.size and (idx[0] < 0 or idx[-1] >= len(self._arr)):
            raise IndexError("index out of range")
        return self._arr[idx]


@pytest.mark.parametrize("share", [None, (1, 2)])
@pytest.mark.parametrize("source", ["numpy", "store", "store_numpy",
                                    "sorted_only"])
def test_gather_into_slot_byte_equal(tmp_path, source, share):
    """The split's gather into a caller's slot (``feature_out``) gives the
    bytes of a gather into a fresh array, for a full batch and the padded
    last one (7 images, batch 4), whole and a rank's half; the batch's
    features are the slot; an out-of-range row still raises."""
    arr = np.random.default_rng(3).standard_normal((7, 2, 8)).astype(
        np.float32)
    np.save(str(tmp_path / "f.npy"), arr)
    src = {"numpy": lambda: arr,
           "store": lambda: FeatureStore(str(tmp_path / "f.npy")),
           "store_numpy": lambda: FeatureStore(str(tmp_path / "f.npy"),
                                               native=False),
           "sorted_only": lambda: _SortedOnly(arr)}[source]()
    assert getattr(src, "is_native", source == "store") == (
        source == "store")
    rows = 4 if share is None else 2
    slots = [np.full((rows, 2, 8), np.nan, np.float32) for _ in range(2)]
    handed = []

    def feature_out():
        handed.append(slots[len(handed) % 2])
        return handed[-1]

    common = dict(existing=np.zeros((7, 3), np.int32),
                  existing_len=np.ones(7, np.int32), target=None,
                  target_len=None, vocab=None,
                  image_index=np.asarray([6, 1, 4, 1, 0, 3, 6], np.int32))
    ds = CaptionDataset(features=src, **common)
    fresh = list(ds.batches(4, share=share))
    n = 0
    for n, (got, want) in enumerate(zip(
            ds.batches(4, share=share, feature_out=feature_out), fresh), 1):
        assert got.features is handed[-1]
        assert got.features.tobytes() == want.features.tobytes()
        np.testing.assert_array_equal(got.valid, want.valid)
    assert n == len(fresh) == len(handed) == 2
    bad = CaptionDataset(features=src, **{
        **common, "image_index": np.asarray([0, 7, 1, 2, 3, 4, 5],
                                            np.int32)})
    with pytest.raises(IndexError):
        next(bad.batches(4, feature_out=lambda: np.empty((4, 2, 8),
                                                         np.float32)))
