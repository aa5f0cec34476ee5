"""The whole serving slice on the CPU against the JAX package on the same
weights: ``decode_split`` over a synthetic split, ``CaptionServer`` and
``serve_stream`` (ladder, flush_ms, error answers) and the ``serve`` CLI
must give the same caption strings as ``captionkit``'s. Also: every entry
point runs on the card by default and raises without one.
"""

import io
import json
import os
import sys
import threading

import jax
import numpy as np
import pytest
import torch

import captionkit.cli as jax_cli
from captionkit.data import SyntheticCaptionSource as JaxSource
from captionkit.decode.driver import decode_split as jax_decode_split
from captionkit.models import get_model as jax_get_model
from captionkit.serve import CaptionServer as JaxServer
from captionkit.serve import serve_stream as jax_serve_stream
from captionkit.train.checkpoint import save_params_npz as jax_save_npz
from captionkit.utils.config import CaptionKitConfig as JaxConfig

from captionkit_torch import cli
from captionkit_torch.config import CaptionKitConfig
from captionkit_torch.data import SyntheticCaptionSource
from captionkit_torch.decode import decode_split, make_decode_fn
from captionkit_torch.models import get_model
from captionkit_torch.params import load_params_npz
from captionkit_torch.serve import CaptionServer, serve_stream

SMALL = {
    "model.emb_dim": 16, "model.hidden_dim": 24, "model.att_dim": 8,
    "model.feat_dim": 12, "model.num_regions": 4, "model.dropout": 0.0,
    "decode.method": "beam", "decode.beam_size": 3,
    "decode.max_decode_len": 8, "decode.batch_size": 4,
    "data.max_existing_len": 12,
}


def _source(cls, n=2):
    return cls(num_images=n, captions_per_image=1, num_regions=4,
               feat_dim=12, max_len=12, seed=0)


def _models(vocab_size, path):
    """(jax cfg, model, params), (port cfg, model, params), the weights
    made by JAX and carried over through the .npz at ``path``."""
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


def test_synthetic_source_matches_jax():
    a, b = _source(JaxSource, 6), _source(SyntheticCaptionSource, 6)
    assert a.vocab.word2id == b.vocab.word2id
    for f in ("features", "existing", "existing_len", "target",
              "target_len", "image_index"):
        np.testing.assert_array_equal(getattr(b.dataset, f),
                                      getattr(a.dataset, f), err_msg=f)
    ja = list(a.eval_view().batches(4, feat_shape=(4, 12)))
    tb = list(b.eval_view().batches(4, feat_shape=(4, 12)))
    assert len(ja) == len(tb) == 2
    for x, y in zip(ja, tb):
        for f in ("features", "existing", "existing_len", "valid",
                  "image_id"):
            np.testing.assert_array_equal(getattr(y, f), getattr(x, f))


def test_decode_split_same_captions(tmp_path):
    """9 images in batches of 4: three batches, two in flight, the last
    padded with rows that are dropped."""
    ds_j = _source(JaxSource, 9).eval_view()
    ds_t = _source(SyntheticCaptionSource, 9).eval_view()
    (jcfg, jm, jp), (tcfg, tm, tp), _ = _models(len(ds_t.vocab),
                                                str(tmp_path / "p.npz"))
    hyps_j, _ = jax_decode_split(jm, jp, ds_j, jcfg.decode)
    hyps_t, stats = decode_split(tm, tp, ds_t, tcfg.decode, device="cpu",
                                 results_path=str(tmp_path / "r.json"))
    assert hyps_t == hyps_j and sorted(hyps_t) == list(range(9))
    assert stats["captions"] == 9.0
    written = json.loads((tmp_path / "r.json").read_text())
    assert [r["caption"] for r in written] == [hyps_t[i] for i in range(9)]


def _requests(n, seed=0):
    rng = np.random.default_rng(seed)
    caps = ["a dog runs", "a man riding a horse", "two people"]
    return [json.dumps({"id": i, "caption": caps[i % 3],
                        "features_inline": rng.standard_normal((4, 12))
                        .round(3).tolist()}) for i in range(n)]


def test_server_same_captions_as_jax_with_ladder(both):
    (jcfg, jm, jp), (tcfg, tm, tp), _ = both
    vocab = _source(SyntheticCaptionSource).vocab
    lines = _requests(7) + [json.dumps({"flush": True})] + _requests(2, 1) \
        + [json.dumps({"id": 99, "features_inline": [[0.0]]}), "not json"]
    jax_server = JaxServer(jcfg, jp, jm, _source(JaxSource).vocab,
                           ladder=(1, 2))
    server = CaptionServer(tcfg, tp, tm, vocab, ladder=(1, 2), device="cpu")
    assert server.ladder == (1, 2, 4)

    seen = []
    inner = server._decode_fn

    def spy(params, feats, ids, lens, step):
        seen.append(int(feats.shape[0]))
        return inner(params, feats, ids, lens, step)

    server._decode_fn = spy
    outs = []
    for fn, srv in ((jax_serve_stream, jax_server), (serve_stream, server)):
        out = io.StringIO()
        fn(srv, io.StringIO("\n".join(lines) + "\n"), out)
        outs.append([json.loads(x) for x in out.getvalue().splitlines()])
    assert outs[1] == outs[0]
    assert outs[1][0] == {"ready": True, "batch": 4, "ladder": [1, 2, 4]}
    # 7 requests: a full batch of 4, then a flush of 3 (rung 4); then 2
    # requests at EOF run on rung 2.
    assert seen == [4, 4, 2]
    answers = [r for r in outs[1] if "caption" in r]
    assert [r["id"] for r in answers] == list(range(7)) + [0, 1]
    errors = [r for r in outs[1] if "error" in r]
    assert errors[0]["id"] == 99 and len(errors) == 2
    with pytest.raises(ValueError):
        CaptionServer(tcfg, tp, tm, vocab, ladder=(8,), device="cpu")


def test_flush_ms_drains_partial_batch_without_eof(both):
    _, (tcfg, tm, tp), _ = both
    server = CaptionServer(tcfg, tp, tm, _source(SyntheticCaptionSource).vocab,
                           ladder=(1,), device="cpu")
    server.warmup()
    r_fd, w_fd = os.pipe()
    in_stream, writer = os.fdopen(r_fd, "r"), os.fdopen(w_fd, "w")
    out = io.StringIO()
    answered = threading.Event()

    class _Out:
        def write(self, s):
            out.write(s)
            if '"caption"' in s:
                answered.set()
            return len(s)

        def flush(self):
            pass

    def client():
        writer.write(_requests(1)[0] + "\n")
        writer.flush()
        # The connection stays open until the flush_ms bound answers.
        assert answered.wait(timeout=30), "no flush within 30 s"
        writer.close()

    t = threading.Thread(target=client)
    t.start()
    served = serve_stream(server, in_stream, _Out(), flush_ms=50)
    t.join()
    assert served == 1
    last = json.loads(out.getvalue().splitlines()[-1])
    assert last["id"] == 0 and isinstance(last["caption"], str)


def test_cli_serve_same_output_as_jax_cli(both, monkeypatch, capsys):
    _, _, path = both
    sets = [a for k, v in SMALL.items() if not k.startswith("decode.batch")
            for a in ("--set", f"{k}={v}")]
    argv = ["serve", "--synthetic", "--params", path, "--batch", "4",
            "--ladder", "1", *sets]
    stdin = "\n".join(_requests(5)) + "\n"
    outs = []
    for main, extra in ((jax_cli.main, ["--platform", "cpu"]),
                        (cli.main, [])):
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
        args = extra + argv + (["--device", "cpu"] if main is cli.main
                               else [])
        assert main(args) == 0
        outs.append(capsys.readouterr().out.splitlines())
    assert outs[1] == outs[0]
    assert len(outs[1]) == 6


def test_cli_unported_commands_exit(capsys):
    """Nothing is left unported: the port's parser offers every
    subcommand of the reference's."""
    import argparse

    assert cli.main(["configs"]) == 0
    assert "editnet_beam5" in capsys.readouterr().out

    def commands(parser):
        return {name for a in parser._actions
                if isinstance(a, argparse._SubParsersAction)
                for name in a.choices}

    want = commands(jax_cli.build_parser())
    assert {"convert", "parity-gate"} <= want
    assert commands(cli.build_parser()) == want
    assert not hasattr(cli, "NOT_PORTED")


def test_entry_points_default_to_the_card(both):
    """device left at its default is "cuda": without a card it raises
    instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, (tcfg, tm, tp), _ = both
    vocab = _source(SyntheticCaptionSource).vocab
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CaptionServer(tcfg, tp, tm, vocab)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_decode_fn(tm, tcfg.decode, start_id=2, end_id=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decode_split(tm, tp, _source(SyntheticCaptionSource).eval_view(),
                     tcfg.decode)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["serve", "--synthetic"])


def test_unported_decode_options_raise(both):
    """Greedy, sampling and ``beam_size`` 1 (which decodes greedily, as in
    the reference) decode; an unknown method raises; the ``backptr`` beam
    layout (ported since) decodes the register layout's tokens; the int8
    feed is staged and answers."""
    _, (tcfg, tm, tp), _ = both
    ex = torch.from_numpy(np.random.default_rng(1).integers(4, 15, (2, 6)))
    ln = torch.tensor([6, 3])
    feats = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 4, 12)).astype(np.float32))
    toks = {}
    for name, over in (("greedy", {"decode.method": "greedy"}),
                       ("sample", {"decode.method": "sample"}),
                       ("beam1", {"decode.beam_size": 1})):
        dc = tcfg.override(over).decode
        toks[name] = make_decode_fn(tm, dc, start_id=2, end_id=3,
                                    device="cpu")(tp, feats, ex, ln)
        assert tuple(toks[name].shape) == (2, 8)
    assert torch.equal(toks["greedy"], toks["beam1"])
    with pytest.raises(ValueError, match="unknown decode method"):
        make_decode_fn(tm, tcfg.override({"decode.method": "topk"}).decode,
                       start_id=2, end_id=3, device="cpu")
    dc = tcfg.override({"decode.beam_impl": "backptr"}).decode
    assert torch.equal(
        make_decode_fn(tm, dc, start_id=2, end_id=3, device="cpu")(
            tp, feats, ex, ln),
        make_decode_fn(tm, tcfg.decode, start_id=2, end_id=3,
                       device="cpu")(tp, feats, ex, ln))
    # The int8 feed is ported: decode_split stages it and answers.
    dc = tcfg.override({"decode.feed_dtype": "int8"}).decode
    hyps, _ = decode_split(tm, tp, _source(SyntheticCaptionSource)
                           .eval_view(), dc, device="cpu")
    assert sorted(hyps) == [0, 1]


def test_bf16_feed_same_captions_as_jax(both):
    (jcfg, jm, jp), (tcfg, tm, tp), _ = both
    over = {"decode.feed_dtype": "bfloat16"}
    feats = np.random.default_rng(4).standard_normal((3, 4, 12)).astype(
        np.float32)
    caps = ["a dog runs", "a cat", "two people"]
    a = JaxServer(jcfg.override(over), jp, jm,
                  _source(JaxSource).vocab).run_batch(feats, caps)
    b = CaptionServer(tcfg.override(over), tp, tm,
                      _source(SyntheticCaptionSource).vocab,
                      device="cpu").run_batch(feats, caps)
    assert a == b
