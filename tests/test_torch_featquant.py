"""The port's int8 feature feed (``captionkit_torch.data.featquant``,
``decode.feed_dtype="int8"``) against ``captionkit.data.featquant`` and the
JAX decode driver, server and CLI on the CPU.

The host-side quantization is the same numpy code on both sides, so it is
byte-equal; dequantization is one fp32 multiply and one bf16 cast on both
sides, so it is bit-equal. End to end the int8-fed port answers with the
JAX package's captions on the same weights, and on features that lie on
the int8 grid (per-region max 127, so scale 1) with the bf16-fed port's.
"""

import dataclasses
import io
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import captionkit.cli as jax_cli
from captionkit.data import SyntheticCaptionSource as JaxSource
from captionkit.data import featquant as jfq
from captionkit.decode.driver import decode_split as jax_decode_split
from captionkit.models import get_model as jax_get_model
from captionkit.serve import CaptionServer as JaxServer
from captionkit.train.checkpoint import save_params_npz as jax_save_npz
from captionkit.utils.config import CaptionKitConfig as JaxConfig

from captionkit_torch import cli
from captionkit_torch.config import CaptionKitConfig
from captionkit_torch.data import SyntheticCaptionSource
from captionkit_torch.data import featquant as tfq
from captionkit_torch.decode import decode_split, make_decode_fn
from captionkit_torch.models import get_model
from captionkit_torch.params import load_params_npz
from captionkit_torch.serve import CaptionServer

SMALL = {
    "model.emb_dim": 16, "model.hidden_dim": 24, "model.att_dim": 8,
    "model.feat_dim": 12, "model.num_regions": 4, "model.dropout": 0.0,
    "decode.method": "beam", "decode.beam_size": 3,
    "decode.max_decode_len": 8, "decode.batch_size": 4,
    "data.max_existing_len": 12,
}
INT8 = {"decode.feed_dtype": "int8"}


def _feats(shape, seed=0, scale=10.0):
    rng = np.random.default_rng(seed)
    f = (rng.standard_normal(shape) * scale).astype(np.float32)
    f[..., 1, :] = 0.0  # an all-zero region: scale 1
    return f


def _grid_feats(rng, shape):
    """Integers in [-127, 127] with per-region |max| 127: scale 1, so the
    int8 feed carries them exactly (tests/test_featquant.py)."""
    feats = rng.integers(-127, 128, size=shape).astype(np.float32)
    feats[..., 0] = 127.0
    return feats


@pytest.mark.parametrize("shape", [(3, 5, 64), (2, 36, 2048), (4, 7)])
def test_quantize_features_byte_equal_to_jax(shape):
    f = _feats(shape, seed=len(shape))
    jq, js = jfq.quantize_features(f)
    tq, ts = tfq.quantize_features(f)
    assert tq.dtype == np.int8 and ts.dtype == np.float32
    assert tq.tobytes() == jq.tobytes() and ts.tobytes() == js.tobytes()
    assert bool(np.all(ts[..., 1] == 1.0))


@pytest.mark.parametrize("shape", [(3, 5, 64), (2, 36, 2048)])
def test_dequantize_features_bit_equal_to_jax(shape):
    q, s = jfq.quantize_features(_feats(shape, seed=7))
    j = jfq.dequantize_features(jnp.asarray(q), jnp.asarray(s))
    t = tfq.dequantize_features(torch.from_numpy(q), torch.from_numpy(s))
    assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
    # Compared as bf16 bit patterns.
    np.testing.assert_array_equal(
        t.view(torch.int16).numpy(),
        np.asarray(j).view(np.int16))


def test_feed_staging_and_round_trip():
    f = _feats((2, 5, 16), seed=3)
    assert tfq.feed_torch_dtype("int8") == torch.int8
    with pytest.raises(ValueError, match="feed_dtype"):
        tfq.feed_torch_dtype("int4")
    staged = tfq.quantize_for_feed(f, "int8")
    assert isinstance(staged, tuple) and len(staged) == 2
    q, s = staged
    assert q.dtype == torch.int8 and q.device.type == "cpu"
    assert s.dtype == torch.float32 and tuple(s.shape) == (2, 5)
    assert tfq.quantize_for_feed(None, "int8") is None
    moved = tfq.feed_to_device(staged, "cpu")
    deq = tfq.dequantize_for_feed(moved, "int8")
    assert deq.dtype == torch.bfloat16
    amax = np.abs(f).max(axis=-1, keepdims=True)
    # quantization (amax / 254) + bf16 rounding (~amax / 256)
    assert np.all(np.abs(deq.float().numpy() - f) <= amax * 0.012 + 1e-6)
    bf = tfq.quantize_for_feed(f, "bfloat16")
    assert bf.dtype == torch.bfloat16
    assert tfq.dequantize_for_feed(bf, "bfloat16") is bf
    with pytest.raises(TypeError, match="pair"):
        tfq.dequantize_for_feed(bf, "int8")


def _source(cls, n=2):
    return cls(num_images=n, captions_per_image=1, num_regions=4,
               feat_dim=12, max_len=12, seed=0)


def _models(vocab_size, path):
    """(JAX cfg, model, params), (port cfg, model, params), JAX weights
    carried over through the .npz at ``path``, and the path."""
    over = dict(SMALL, **{"model.vocab_size": vocab_size})
    jcfg = JaxConfig().override(over)
    jm = jax_get_model(jcfg.model)
    jp = jm.init(jax.random.PRNGKey(0))
    jax_save_npz(jp, path)
    tcfg = CaptionKitConfig().override(over)
    tm = get_model(tcfg.model)
    return (jcfg, jm, jp), (tcfg, tm, load_params_npz(path, "cpu")), path


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The models over the vocab of the CLI's --synthetic mode."""
    return _models(len(_source(JaxSource).vocab),
                   str(tmp_path_factory.mktemp("w") / "params.npz"))


def test_decode_fn_int8_feed_matches_bf16_on_grid(both):
    _, (tcfg, tm, tp), _ = both
    vocab = _source(SyntheticCaptionSource).vocab
    feats = _grid_feats(np.random.default_rng(7), (4, 4, 12))
    ids = np.zeros((4, 12), np.int64)
    lens = np.zeros((4,), np.int64)
    for i, cap in enumerate(["a dog runs", "a cat sits", "a man rides",
                             "a bird flies"]):
        ids[i], lens[i] = vocab.encode(cap.split(), max_len=12)
    outs = {}
    for feed in ("bfloat16", "int8"):
        dcfg = dataclasses.replace(tcfg.decode, feed_dtype=feed)
        fn = make_decode_fn(tm, dcfg, start_id=vocab.start, end_id=vocab.end,
                            pad_id=vocab.pad, device="cpu")
        outs[feed] = fn(tp, tfq.quantize_for_feed(feats, feed),
                        torch.from_numpy(ids), torch.from_numpy(lens)).numpy()
    np.testing.assert_array_equal(outs["int8"], outs["bfloat16"])


def test_server_int8_feed_same_captions_as_jax(both):
    """CaptionServer on the int8 feed answers with the JAX server's
    captions (the analog of tests/test_featquant.py's server test), and
    what it hands the decode function is the (q, scale) pair; a partial
    batch pads by repeating its last row before quantization."""
    (jcfg, jm, jp), (tcfg, tm, tp), _ = both
    feats = _feats((3, 4, 12), seed=11, scale=2.0)
    caps = ["a dog runs", "a cat", "two people"]
    a = JaxServer(jcfg.override(INT8), jp, jm, _source(JaxSource).vocab,
                  ladder=(1,)).run_batch(feats, caps)
    server = CaptionServer(tcfg.override(INT8), tp, tm,
                           _source(SyntheticCaptionSource).vocab,
                           ladder=(1,), device="cpu")
    fed = []
    inner = server._decode_fn

    def spy(params, f, ids, lens, step):
        fed.append((f[0].dtype, f[1].dtype, tuple(f[1].shape)))
        q, s = tfq.quantize_features(np.concatenate([feats, feats[-1:]]))
        assert np.array_equal(f[0].numpy(), q)
        assert np.array_equal(f[1].numpy(), s)
        return inner(params, f, ids, lens, step)

    server._decode_fn = spy
    assert server.run_batch(feats, caps) == a
    assert fed == [(torch.int8, torch.float32, (4, 4))]


def test_decode_split_int8_feed_same_captions_as_jax(tmp_path):
    """decode_split stages the int8 feed itself, batch by batch (9 images,
    the last batch padded), and gives the JAX driver's captions."""
    (jcfg, jm, jp), (tcfg, tm, tp), _ = _models(
        len(_source(JaxSource, 9).vocab), str(tmp_path / "p.npz"))
    hyps_j, _ = jax_decode_split(jm, jp, _source(JaxSource, 9).eval_view(),
                                 jcfg.override(INT8).decode)
    hyps_t, stats = decode_split(tm, tp,
                                 _source(SyntheticCaptionSource, 9)
                                 .eval_view(), tcfg.override(INT8).decode,
                                 device="cpu")
    assert hyps_t == hyps_j and stats["captions"] == 9.0


@pytest.mark.parametrize("head_sets", [
    [], ["--set", "model.head_quant=int8"],
    ["--set", "model.head_quant=int8", "--set", "model.head_extract=thresh"],
])
def test_cli_serve_int8_same_as_jax(both, head_sets, monkeypatch, capsys):
    """``serve --set decode.feed_dtype=int8 [--set model.head_quant=int8
    [--set model.head_extract=thresh]]``: the port's CLI answers the JAX
    CLI's lines."""
    _, _, path = both
    sets = [a for k, v in SMALL.items() if k != "decode.batch_size"
            for a in ("--set", f"{k}={v}")]
    argv = ["serve", "--config", "editnet_beam5", "--synthetic", "--params",
            path, "--batch", "4", "--ladder", "1", *sets,
            "--set", "decode.feed_dtype=int8", *head_sets]
    rng = np.random.default_rng(5)
    stdin = "\n".join(json.dumps(
        {"id": i, "caption": ["a dog runs", "two people"][i % 2],
         "features_inline": rng.standard_normal((4, 12)).round(3).tolist()})
        for i in range(5)) + "\n"
    outs = []
    for main, args in ((jax_cli.main, ["--platform", "cpu", *argv]),
                       (cli.main, [*argv, "--device", "cpu"])):
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
        assert main(args) == 0
        outs.append(capsys.readouterr().out.splitlines())
    assert outs[1] == outs[0]
    assert len(outs[1]) == 6
