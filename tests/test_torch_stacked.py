"""The port's stacked DCNet -> EditNet editing
(``captionkit_torch.decode.stacked``, ``cli decode-stacked`` and ``serve
--stacked``) against ``captionkit`` on the CPU: the same weights (JAX
inits, through the bridge or the reference's ``.npz``), the same inputs
from a numpy seed, fp32.

Tolerances: tokens, results files and printed metrics identical (at fp32
both packages decode the same captions).
"""

import contextlib
import io
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import captionkit.cli as jax_cli
from captionkit.data.featquant import quantize_for_feed as j_quantize
from captionkit.decode.stacked import make_stacked_decode_fn as j_stacked
from captionkit.decode.stacked import rollout_to_existing as j_rewrap
from captionkit.models import ensemble_model as j_ensemble
from captionkit.models import get_model as jax_get_model
from captionkit.models import stack_params as j_stack
from captionkit.train.checkpoint import save_params_npz as jax_save_npz
from captionkit.utils.config import DecodeConfig as JaxDecodeConfig
from captionkit.utils.config import ModelConfig as JaxModelConfig

from captionkit_torch import cli
from captionkit_torch.config import DecodeConfig, ModelConfig
from captionkit_torch.data.featquant import quantize_for_feed
from captionkit_torch.decode.stacked import (
    make_stacked_decode_fn,
    rollout_to_existing,
)
from captionkit_torch.models import get_model
from captionkit_torch.models.ensemble import ensemble_model, stack_params
from captionkit_torch.params import (
    dcnet_params_from_numpy,
    editnet_params_from_numpy,
)

CFG = dict(vocab_size=40, emb_dim=12, hidden_dim=16, att_dim=8,
           feat_dim=10, num_regions=4, dropout=0.0, compute_dtype="float32")
START, END, PAD = 2, 3, 0
B, T = 4, 8


def _flat(jp):
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    return {"/".join(str(getattr(k, "name", k)) for k in path):
            np.asarray(leaf) for path, leaf in flat if leaf is not None}


def test_rollout_to_existing_matches_jax():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 40, (3, 5)).astype(np.int32)
    lens = np.asarray([5, 2, 0], np.int32)
    je, jl = j_rewrap(jnp.asarray(toks), jnp.asarray(lens), start_id=START,
                      pad_id=PAD)
    te, tl = rollout_to_existing(torch.from_numpy(toks),
                                 torch.from_numpy(lens), start_id=START,
                                 pad_id=PAD)
    assert te.shape == (3, 6) and te.dtype == torch.int32
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@pytest.mark.parametrize("second,feed,members", [
    ("beam", "float32", 1), ("greedy", "float32", 1), ("beam", "int8", 1),
    ("beam", "float32", 2)])
def test_stacked_decode_matches_jax(second, feed, members):
    """DCNet greedy, then EditNet greedy or beam (a two-checkpoint
    ensemble in the last case), on float or int8-fed features: the same
    tokens as JAX's stacked program."""
    jd = jax_get_model(JaxModelConfig(arch="dcnet", **CFG))
    je = jax_get_model(JaxModelConfig(arch="editnet", **CFG))
    td = get_model(ModelConfig(arch="dcnet", **CFG))
    te = get_model(ModelConfig(arch="editnet", **CFG))
    jdp = jd.init(jax.random.PRNGKey(0))
    jeps = [je.init(jax.random.PRNGKey(1 + i)) for i in range(members)]
    tdp = dcnet_params_from_numpy(_flat(jdp), "cpu")
    teps = [editnet_params_from_numpy(_flat(p), "cpu") for p in jeps]
    jep, tep = jeps[0], teps[0]
    if members > 1:
        je, jep = j_ensemble(je, members), j_stack(jeps)
        te, tep = ensemble_model(te, members), stack_params(teps)
    first = dict(method="greedy", beam_size=1, max_decode_len=9)
    stage2 = dict(method=second, beam_size=3 if second == "beam" else 1,
                  max_decode_len=9)
    ids = dict(start_id=START, end_id=END, pad_id=PAD, feed_dtype=feed)
    jfn = j_stacked(jd, je, first_stage=JaxDecodeConfig(**first),
                    second_stage=JaxDecodeConfig(**stage2), **ids)
    tfn = make_stacked_decode_fn(td, te, first_stage=DecodeConfig(**first),
                                 second_stage=DecodeConfig(**stage2),
                                 device="cpu", **ids)
    rng = np.random.default_rng(members)
    feats = rng.standard_normal((B, 4, 10)).astype(np.float32)
    existing = rng.integers(4, 40, (B, T)).astype(np.int32)
    lens = np.asarray([8, 6, 4, 8], np.int32)
    want = np.asarray(jfn(jdp, jep, j_quantize(feats, feed),
                          jnp.asarray(existing), jnp.asarray(lens)))
    got = tfn(tdp, tep, quantize_for_feed(feats, feed),
              torch.from_numpy(existing).long(), torch.from_numpy(lens)
              .long())
    assert got.shape == (B, 9)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="greedy/beam stages"):
        make_stacked_decode_fn(td, te, first_stage=DecodeConfig(
            method="sample"), second_stage=DecodeConfig(), device="cpu",
            **ids)


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return json.loads(out.getvalue())


SETS = {**{f"model.{k}": v for k, v in CFG.items() if k != "vocab_size"},
        "model.feat_dim": 12, "decode.beam_size": 3,
        "decode.max_decode_len": 8, "decode.batch_size": 4}


def _npz(tmp, **source):
    """A DCNet and two EditNet ``.npz`` files of JAX inits (the
    reference's ``save_params_npz``) at the vocab of the synthetic split
    ``source`` describes."""
    from captionkit.data import SyntheticCaptionSource as JSource

    v = len(JSource(num_regions=4, feat_dim=12, seed=0, **source).vocab)
    paths = {}
    for name, arch, seed in (("dc", "dcnet", 0), ("ed", "editnet", 1),
                             ("ed2", "editnet", 2)):
        m = jax_get_model(JaxModelConfig(arch=arch, **{
            **CFG, "vocab_size": v, "feat_dim": 12}))
        paths[name] = str(tmp / f"{name}_{v}.npz")
        jax_save_npz(m.init(jax.random.PRNGKey(seed)), paths[name])
    return paths


@pytest.mark.parametrize("editnet", ["ed", "ed,ed2"])
def test_cli_decode_stacked_identical_to_jax(tmp_path, editnet):
    """``decode-stacked`` over a synthetic split (the CLI's own: 6 images,
    the data config's 5 captions each) with one EditNet checkpoint or two
    (an ensemble stage): byte-identical results files and equal metrics
    to the reference CLI's."""
    tmp = tmp_path
    paths = _npz(tmp, num_images=6, captions_per_image=5, max_len=22)
    sets = [a for k, v in SETS.items() for a in ("--set", f"{k}={v}")]
    ed = ",".join(paths[p] for p in editnet.split(","))
    outs = {}
    for who, main, extra in (("j", jax_cli.main, ["--platform", "cpu"]),
                             ("t", cli.main, [])):
        path = tmp / f"stacked_{who}_{len(editnet)}.json"
        argv = extra + ["decode-stacked", "--config", "editnet_beam5",
                        "--synthetic", "--images", "6", *sets,
                        "--dcnet-params", paths["dc"], "--editnet-params",
                        ed, "--out", str(path)]
        outs[who] = (_run(main, argv + (["--device", "cpu"] if who == "t"
                                        else [])), path.read_bytes())
    assert outs["t"][1] == outs["j"][1]
    assert outs["t"][0] == outs["j"][0]
    assert outs["t"][0]["captions"] == 6 and "CIDEr" in outs["t"][0]
    got = _run(cli.main, ["decode-stacked", "--config", "editnet_beam5",
                          "--synthetic", "--images", "6", *sets,
                          "--no-metrics", "--device", "cpu"])
    assert got == {"captions": 6}


def test_cli_serve_stacked_answers_like_jax(tmp_path, monkeypatch, capsys):
    """``serve --stacked``: every request answered, the same lines as the
    reference's stacked server."""
    paths = _npz(tmp_path, num_images=2, captions_per_image=1, max_len=12)
    sets = [a for k, v in SETS.items() if k != "decode.batch_size"
            for a in ("--set", f"{k}={v}")]
    rng = np.random.default_rng(0)
    caps = ["a dog runs", "a man riding a horse", "two people"]
    lines = [json.dumps({"id": i, "caption": caps[i % 3],
                         "features_inline": rng.standard_normal((4, 12))
                         .round(3).tolist()}) for i in range(5)]
    argv = ["serve", "--synthetic", "--stacked", "--dcnet-params",
            paths["dc"], "--params", paths["ed"], "--batch", "4",
            "--ladder", "1", *sets]
    outs = []
    for main, extra, post in ((jax_cli.main, ["--platform", "cpu"], []),
                              (cli.main, [], ["--device", "cpu"])):
        monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(lines)
                                                      + "\n"))
        assert main(extra + argv + post) == 0
        outs.append(capsys.readouterr().out.splitlines())
    assert outs[1] == outs[0]
    answers = [json.loads(x) for x in outs[1][1:]]
    assert sorted(a["id"] for a in answers) == list(range(5))
    assert all(isinstance(a["caption"], str) for a in answers)
