"""Decoding and scoring a split with the port (``decode.driver
.evaluate_split`` and ``cli decode``) against ``captionkit`` on the CPU, on
the same prepared split, the same weights (JAX init, through the flat-name
bridge or the ``.npz`` that the reference's ``save_params_npz`` writes)
and the same config.

At fp32 both packages decode the same hypotheses, so the results files
must be byte-identical and the metrics dicts equal, timing keys aside. The
test split holds 7 images decoded in batches of 4, so the last batch
carries padding rows, which must reach neither the results nor the
scores; the results key by the prepared split's real image ids.
"""

import contextlib
import io
import json

import jax
import numpy as np
import pytest

import captionkit.cli as jax_cli
from captionkit.data.prepare import load_prepared_split as j_load_prepared
from captionkit.data.prepare import prepare_from_karpathy as j_prepare
from captionkit.decode.driver import evaluate_split as j_evaluate_split
from captionkit.models import get_model as jax_get_model
from captionkit.train.checkpoint import save_params_npz as jax_save_npz
from captionkit.utils.config import DecodeConfig as JaxDecodeConfig
from captionkit.utils.config import ModelConfig as JaxModelConfig

from captionkit_torch import cli
from captionkit_torch.config import DecodeConfig, ModelConfig
from captionkit_torch.data.prepare import load_prepared_split
from captionkit_torch.decode.driver import evaluate_split
from captionkit_torch.models import get_model
from captionkit_torch.params import (
    dcnet_params_from_numpy,
    editnet_params_from_numpy,
)

R, F = 5, 12
SMALL = dict(emb_dim=16, hidden_dim=24, att_dim=8, feat_dim=F,
             num_regions=R, dropout=0.0, compute_dtype="float32")
DECODE = dict(method="beam", beam_size=3, batch_size=4, max_decode_len=10)
TIMING = ("wall_s", "captions_per_sec")
WORDS = ("a man woman dog cat rides holds runs sits near on in the park "
         "beach bench horse red blue small").split()
FIRST_ID = 4000


@pytest.fixture(scope="module")
def split_dir(tmp_path_factory):
    """A prepared split (reference prepare): 12 train and 7 test images
    with 5 references each, real ids from 4000 in steps of 3."""
    tmp = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(0)
    images, existing = [], {"train": [], "test": []}
    for i, split in enumerate(["train"] * 12 + ["test"] * 7):
        caps = [[WORDS[j] for j in rng.integers(0, len(WORDS),
                                                int(rng.integers(3, 9)))]
                for _ in range(5)]
        images.append({"split": split, "cocoid": FIRST_ID + 3 * i,
                       "sentences": [{"tokens": c} for c in caps]})
        existing[split].append({"image_id": FIRST_ID + 3 * i,
                                "caption": " ".join(caps[1][1:])})
    (tmp / "k.json").write_text(json.dumps({"images": images}))
    epaths = {}
    for split, rows in existing.items():
        epaths[split] = str(tmp / f"ex_{split}.json")
        (tmp / f"ex_{split}.json").write_text(json.dumps(rows))
    feats = str(tmp / "feats_test.npy")
    np.save(feats, rng.standard_normal((7, R, F)).astype(np.float32))
    j_prepare(karpathy_json=str(tmp / "k.json"), output_dir=str(tmp / "p"),
              existing_captions=epaths, features={"test": feats},
              min_word_freq=1)
    return tmp


def _flat(jp):
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    return {"/".join(str(getattr(k, "name", k)) for k in path):
            np.asarray(leaf) for path, leaf in flat if leaf is not None}


@pytest.mark.parametrize("arch", ["editnet", "dcnet"])
def test_evaluate_split_identical_to_jax(split_dir, arch):
    j_ds = j_load_prepared(str(split_dir / "p"), "test").eval_view()
    t_ds = load_prepared_split(str(split_dir / "p"), "test").eval_view()
    kw = dict(SMALL, arch=arch, vocab_size=len(t_ds.vocab))
    jm = jax_get_model(JaxModelConfig(**kw))
    jp = jm.init(jax.random.PRNGKey(0))
    bridge = (editnet_params_from_numpy if arch == "editnet"
              else dcnet_params_from_numpy)
    tm, tp = get_model(ModelConfig(**kw)), bridge(_flat(jp), "cpu")
    j_out, t_out = split_dir / f"j_{arch}.json", split_dir / f"t_{arch}.json"
    want = j_evaluate_split(jm, jp, j_ds, JaxDecodeConfig(**DECODE),
                            results_path=str(j_out))
    got = evaluate_split(tm, tp, t_ds, DecodeConfig(**DECODE),
                         results_path=str(t_out), device="cpu")
    assert t_out.read_bytes() == j_out.read_bytes()
    results = json.loads(t_out.read_text())
    assert [r["image_id"] for r in results] == [
        FIRST_ID + 3 * (12 + i) for i in range(7)]
    assert {k: v for k, v in got.items() if k not in TIMING} == \
        {k: v for k, v in want.items() if k not in TIMING}
    assert got["captions"] == 7.0 and got["captions_per_sec"] > 0
    assert {"BLEU-1", "BLEU-4", "ROUGE-L", "CIDEr"} <= set(got)
    with pytest.raises(ValueError, match="no reference"):
        evaluate_split(tm, tp, t_ds.__class__(**{
            **t_ds.__dict__, "references": None}), DecodeConfig(**DECODE),
            device="cpu")


@pytest.fixture(scope="module")
def params_npz(split_dir):
    vocab = len(load_prepared_split(str(split_dir / "p"), "test").vocab)
    jm = jax_get_model(JaxModelConfig(arch="editnet", vocab_size=vocab,
                                      **SMALL))
    path = str(split_dir / "params.npz")
    jax_save_npz(jm.init(jax.random.PRNGKey(1)), path)
    return path


def _sets():
    over = {**{f"model.{k}": v for k, v in SMALL.items()},
            **{f"decode.{k}": v for k, v in DECODE.items()}}
    return [a for k, v in over.items() for a in ("--set", f"{k}={v}")]


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return json.loads(out.getvalue())


def _strip(metrics):
    return {k: v for k, v in metrics.items() if k not in TIMING}


def _decode_both(split_dir, params_npz, name, *extra):
    """The reference CLI and the port's on the same arguments: (printed
    metrics, results file) of each."""
    argv = ["decode", "--config", "editnet_beam5", "--params", params_npz,
            *_sets(), *extra]
    outs = {}
    for who, main, pre, post in (
            ("j", jax_cli.main, ["--platform", "cpu"], []),
            ("t", cli.main, [], ["--device", "cpu"])):
        path = split_dir / f"{name}_{who}.json"
        outs[who] = (_run(main, pre + argv + post + ["--out", str(path)]),
                     path.read_bytes())
    return outs["t"], outs["j"]


def test_cli_decode_prepared_identical_to_jax(split_dir, params_npz):
    (got, got_file), (want, want_file) = _decode_both(
        split_dir, params_npz, "prepared", "--prepared",
        str(split_dir / "p"), "--split", "test")
    assert got_file == want_file
    assert _strip(got) == _strip(want)
    assert list(got) == list(want)  # the reference's keys and order
    assert all(v == round(v, 4) for v in got.values())
    assert [r["image_id"] for r in json.loads(got_file)] == [
        FIRST_ID + 3 * (12 + i) for i in range(7)]
    # The raw reference files of the same split: the same captions, in
    # dense image order (raw artifacts carry no image ids).
    p = split_dir / "p"
    raw = _run(cli.main, [
        "decode", "--config", "editnet_beam5", "--params", params_npz,
        *_sets(), "--wordmap", str(p / "WORDMAP.json"),
        "--captions", str(p / "TEST_CAPTIONS.json"),
        "--caplens", str(p / "TEST_CAPLENS.json"),
        "--existing", str(p / "TEST_EXISTING.json"),
        "--existing-lens", str(p / "TEST_EXISTING_CAPLENS.json"),
        "--features", str(p / "TEST_FEATURES.npy"),
        "--out", str(split_dir / "raw.json"), "--device", "cpu"])
    raw_caps = [r["caption"] for r in
                json.loads((split_dir / "raw.json").read_text())]
    assert raw_caps == [r["caption"] for r in json.loads(got_file)]
    for key in ("BLEU-1", "BLEU-2", "BLEU-3", "BLEU-4", "ROUGE-L", "CIDEr"):
        assert raw[key] == got[key], key


def test_cli_decode_no_metrics_and_shards_identical_to_jax(split_dir,
                                                           params_npz):
    (got, got_file), (want, want_file) = _decode_both(
        split_dir, params_npz, "shard", "--prepared", str(split_dir / "p"),
        "--split", "test", "--no-metrics", "--num-shards", "2",
        "--shard-index", "1")
    assert got_file == want_file
    assert sorted(got) == ["captions", "captions_per_sec", "wall_s"]
    assert _strip(got) == _strip(want) == {"captions": 3.0}
    assert [r["image_id"] for r in json.loads(got_file)] == [
        FIRST_ID + 3 * (12 + i) for i in (1, 3, 5)]


def test_cli_decode_refuses_ensembles_and_defaults_to_the_card(split_dir,
                                                               params_npz):
    """A two-checkpoint ``--params a,b`` decodes the checkpoint ensemble:
    the same results file and metrics as the reference CLI's ensemble, in
    both modes; without ``--device`` the decode asks for the card."""
    vocab = len(load_prepared_split(str(split_dir / "p"), "test").vocab)
    jm = jax_get_model(JaxModelConfig(arch="editnet", vocab_size=vocab,
                                      **SMALL))
    second = str(split_dir / "params_b.npz")
    jax_save_npz(jm.init(jax.random.PRNGKey(2)), second)
    for mode in ("logprob", "prob"):
        (got, got_file), (want, want_file) = _decode_both(
            split_dir, f"{params_npz},{second}", f"ens_{mode}",
            "--prepared", str(split_dir / "p"), "--split", "test",
            "--ensemble-mode", mode)
        assert got_file == want_file
        assert _strip(got) == _strip(want)
    argv = ["decode", "--config", "editnet_beam5", "--synthetic",
            "--images", "3", *_sets()]
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv)
    got = _run(cli.main, argv + ["--device", "cpu", "--no-metrics"])
    assert got["captions"] == 3.0


@pytest.mark.parametrize("layout", ["float64", "fortran_float32",
                                    "big_endian"])
def test_npy_layouts_the_native_gather_cannot_read_decode_as_in_jax(
        split_dir, layout):
    """A feature ``.npy`` of float64, Fortran order or big-endian loads
    through the numpy gather (``load_hdf5_features``, as the reference's)
    and decodes and scores as the reference does."""
    from captionkit.data.sources import load_hdf5_features as j_load

    from captionkit_torch.data.sources import load_hdf5_features

    base = np.load(str(split_dir / "feats_test.npy"))
    arr = {"float64": base.astype(np.float64),
           "fortran_float32": np.asfortranarray(base),
           "big_endian": base.astype(">f4")}[layout]
    path = str(split_dir / f"feats_{layout}.npy")
    np.save(path, arr)
    t_feats, j_feats = load_hdf5_features(path), j_load(path)
    assert not t_feats.is_native
    idx = np.asarray([6, 0, 3, 3])
    np.testing.assert_array_equal(t_feats.gather(idx), j_feats.gather(idx))
    j_ds = j_load_prepared(str(split_dir / "p"), "test").eval_view()
    t_ds = load_prepared_split(str(split_dir / "p"), "test").eval_view()
    j_ds.features, t_ds.features = j_feats, t_feats
    kw = dict(SMALL, arch="editnet", vocab_size=len(t_ds.vocab))
    jm = jax_get_model(JaxModelConfig(**kw))
    jp = jm.init(jax.random.PRNGKey(0))
    tm, tp = get_model(ModelConfig(**kw)), editnet_params_from_numpy(
        _flat(jp), "cpu")
    j_out, t_out = (split_dir / f"j_{layout}.json",
                    split_dir / f"t_{layout}.json")
    want = j_evaluate_split(jm, jp, j_ds, JaxDecodeConfig(**DECODE),
                            results_path=str(j_out))
    got = evaluate_split(tm, tp, t_ds, DecodeConfig(**DECODE),
                         results_path=str(t_out), device="cpu")
    assert t_out.read_bytes() == j_out.read_bytes()
    assert _strip(got) == _strip(want)
