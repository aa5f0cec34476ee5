"""The port's greedy and sampling rollouts (``captionkit_torch.decode
.greedy``) against ``captionkit.decode.greedy`` on the CPU, on the same
weights (JAX init, carried over by the flat-name bridge) and the same
numpy inputs; greedy serving through ``CaptionServer`` and the CLI.

Greedy at fp32: tokens, mask and lengths identical, log-probs within 1e-5
(the same fp32 products summed in other orders through a few layers; the
argmax margins of these random weights are far above that). Sampling
draws from a ``torch.Generator``, whose stream is not JAX's: it is held to
greedy at ``top_k=1`` and to the softmax by a chi-square test.
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
from captionkit.decode.greedy import _truncate_logits as jax_truncate
from captionkit.decode.greedy import greedy_decode as jax_greedy
from captionkit.models import get_model as jax_get_model
from captionkit.serve import CaptionServer as JaxServer
from captionkit.train.checkpoint import save_params_npz as jax_save_npz
from captionkit.utils.config import CaptionKitConfig as JaxConfig
from captionkit.utils.config import ModelConfig as JaxModelConfig

from captionkit_torch import cli
from captionkit_torch.config import CaptionKitConfig, ModelConfig
from captionkit_torch.data import SyntheticCaptionSource
from captionkit_torch.decode import greedy_decode, make_decode_fn, sample_decode
from captionkit_torch.decode.driver import sample_seed
from captionkit_torch.decode.greedy import _truncate_logits
from captionkit_torch.models import get_model
from captionkit_torch.models.base import ModelDef
from captionkit_torch.params import (
    dcnet_params_from_numpy,
    editnet_params_from_numpy,
    load_params_npz,
    params_arch,
)
from captionkit_torch.serve import CaptionServer, serve_stream

SMALL = dict(vocab_size=60, emb_dim=16, hidden_dim=24, att_dim=8,
             feat_dim=12, num_regions=5, dropout=0.0, compute_dtype="float32")


def _arrays(jp):
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    return {"/".join(str(getattr(k, "name", k)) for k in path):
            np.asarray(leaf) for path, leaf in flat if leaf is not None}


def _pair(arch, seed=0, **over):
    """(JAX model, params), (port model, params) on the same weights."""
    kw = dict(SMALL, arch=arch, **over)
    jm, tm = jax_get_model(JaxModelConfig(**kw)), get_model(ModelConfig(**kw))
    jp = jm.init(jax.random.PRNGKey(seed))
    arrays = _arrays(jp)
    bridge = (editnet_params_from_numpy if params_arch(arrays) == "editnet"
              else dcnet_params_from_numpy)
    return (jm, jp), (tm, bridge(arrays, "cpu"))


def _inputs(B=6, T=7, seed=1):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, SMALL["num_regions"],
                                 SMALL["feat_dim"])).astype(np.float32)
    ex = rng.integers(4, SMALL["vocab_size"], (B, T)).astype(np.int32)
    ln = rng.integers(2, T + 1, (B,)).astype(np.int32)
    return feats, ex, ln


@pytest.mark.parametrize("arch,over", [
    ("editnet", {}),
    ("editnet", {"scma_select": "hard"}),
    ("dcnet", {}),
    ("dcnet", {"dcnet_use_visual": True}),
])
def test_greedy_identical_to_jax(arch, over):
    (jm, jp), (tm, tp) = _pair(arch, **over)
    feats, ex, ln = _inputs()
    jctx = jm.encode(jp, jnp.asarray(feats), jnp.asarray(ex), jnp.asarray(ln))
    tctx = tm.encode(tp, torch.from_numpy(feats), torch.from_numpy(ex).long(),
                     torch.from_numpy(ln).long())
    # end id 5 finishes some rows early, so pad-after-end is exercised.
    ids = dict(start_id=2, end_id=5, pad_id=0, max_len=12)
    j = jax_greedy(jm, jp, jctx, **ids)
    t = greedy_decode(tm, tp, tctx, **ids)
    np.testing.assert_array_equal(t.tokens.numpy(), np.asarray(j.tokens))
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    np.testing.assert_array_equal(t.lengths.numpy(), np.asarray(j.lengths))
    np.testing.assert_allclose(t.logprobs.numpy(), np.asarray(j.logprobs),
                               atol=1e-5, rtol=0)
    assert t.tokens.dtype == torch.int32 and t.lengths.dtype == torch.int32
    finished = ~t.mask
    assert bool((t.tokens[finished] == 0).all())
    assert bool((t.logprobs[finished] == 0).all())


def test_greedy_argmax_takes_the_first_maximal_index():
    """A model whose logits tie everywhere emits token 0 at every step,
    as jnp.argmax does."""
    V = 7

    def step(params, ctx, state, tok):
        return state, torch.zeros((tok.shape[0], V))

    @dataclasses.dataclass
    class S:
        h: torch.Tensor

    model = ModelDef(name="flat", init=None, encode=None,
                     init_state=lambda p, c, max_len=None: S(
                         torch.zeros((3, 1))),
                     step=step)
    out = greedy_decode(model, None, None, start_id=2, end_id=-1, max_len=4)
    assert out.tokens.tolist() == [[0] * 4] * 3
    torch.testing.assert_close(out.logprobs,
                               torch.full((3, 4), -float(np.log(V))))


@pytest.mark.parametrize("top_k,top_p", [(3, 1.0), (1, 1.0), (0, 0.5),
                                         (0, 0.9), (4, 0.7)])
def test_truncate_logits_identical_to_jax(top_k, top_p):
    rng = np.random.default_rng(top_k * 10 + int(top_p * 10))
    logits = rng.standard_normal((5, 40)).astype(np.float32)
    logits[0, [3, 7, 11]] = 2.5  # ties at the k-th value
    logits[1, :] = 0.25  # a flat row
    want = np.asarray(jax_truncate(jnp.asarray(logits), top_k, top_p))
    got = _truncate_logits(torch.from_numpy(logits), top_k, top_p).numpy()
    np.testing.assert_array_equal(got, want)


def test_sample_top_k_1_equals_greedy():
    (_, _), (tm, tp) = _pair("editnet")
    feats, ex, ln = _inputs()
    ctx = tm.encode(tp, torch.from_numpy(feats), torch.from_numpy(ex).long(),
                    torch.from_numpy(ln).long())
    ids = dict(start_id=2, end_id=5, max_len=10)
    g = greedy_decode(tm, tp, ctx, **ids)
    s = sample_decode(tm, tp, ctx, torch.Generator().manual_seed(3), top_k=1,
                      **ids)
    assert torch.equal(s.tokens, g.tokens)
    # The truncated distribution puts all its mass on the argmax.
    assert bool((s.logprobs == 0).all())


def test_sample_draws_follow_the_softmax():
    """One step of 60,000 rows over fixed logits: the counts of each token
    against the softmax's expected counts, chi-square with 5 degrees of
    freedom below 20.52 (p = 0.001)."""
    probs_logits = torch.tensor([1.0, 0.0, -1.0, 2.0, 0.5, -0.5])
    rows = 60000

    @dataclasses.dataclass
    class S:
        h: torch.Tensor

    def step(params, ctx, state, tok):
        return state, probs_logits.expand(tok.shape[0], -1)

    model = ModelDef(name="fixed", init=None, encode=None,
                     init_state=lambda p, c, max_len=None: S(
                         torch.zeros((rows, 1))),
                     step=step)
    out = sample_decode(model, None, None, torch.Generator().manual_seed(0),
                        start_id=2, end_id=-1, max_len=1)
    counts = torch.bincount(out.tokens[:, 0].long(), minlength=6).double()
    expected = torch.softmax(probs_logits.double(), 0) * rows
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 20.52, (chi2, counts.tolist(), expected.tolist())
    torch.testing.assert_close(
        out.logprobs[:, 0],
        torch.log_softmax(probs_logits, 0)[out.tokens[:, 0].long()])


def test_sampling_decode_fn_seeds_per_batch():
    """``make_decode_fn`` with method "sample": the same seed and batch
    index give the same draws; another batch index other draws."""
    (_, _), (tm, tp) = _pair("editnet")
    feats, ex, ln = _inputs()
    cfg = CaptionKitConfig().override({"decode.method": "sample",
                                       "decode.max_decode_len": 10,
                                       "decode.temperature": 2.0})
    fn = make_decode_fn(tm, cfg.decode, start_id=2, end_id=-1, device="cpu")
    args = (tp, torch.from_numpy(feats), torch.from_numpy(ex).long(),
            torch.from_numpy(ln).long())
    a, b, c = fn(*args, 0), fn(*args, 0), fn(*args, 1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert sample_seed(0, 0) != sample_seed(0, 1) != sample_seed(1, 0)


# -- greedy serving ----------------------------------------------------------

SERVE = {"model.emb_dim": 16, "model.hidden_dim": 24, "model.att_dim": 8,
         "model.feat_dim": 12, "model.num_regions": 4, "model.dropout": 0.0,
         "decode.max_decode_len": 8, "decode.batch_size": 4,
         "data.max_existing_len": 12}


def _source(cls, n=2):
    return cls(num_images=n, captions_per_image=1, num_regions=4,
               feat_dim=12, max_len=12, seed=0)


def _requests(n, seed=0):
    rng = np.random.default_rng(seed)
    caps = ["a dog runs", "a man riding a horse", "two people"]
    return [json.dumps({"id": i, "caption": caps[i % 3],
                        "features_inline": rng.standard_normal((4, 12))
                        .round(3).tolist()}) for i in range(n)]


@pytest.fixture(scope="module")
def greedy_pair(tmp_path_factory):
    """editnet_greedy at a small width, JAX weights through the .npz."""
    path = str(tmp_path_factory.mktemp("g") / "params.npz")
    over = dict(SERVE, **{"model.vocab_size": len(_source(JaxSource).vocab)})
    greedy = {"decode.method": "greedy", "decode.beam_size": 1}
    jcfg = JaxConfig().override({**over, **greedy})
    jm = jax_get_model(jcfg.model)
    jp = jm.init(jax.random.PRNGKey(0))
    jax_save_npz(jp, path)
    tcfg = CaptionKitConfig().override({**over, **greedy})
    return (jcfg, jm, jp), (tcfg, get_model(tcfg.model),
                            load_params_npz(path, "cpu")), path


def test_server_greedy_same_captions_as_jax(greedy_pair):
    (jcfg, jm, jp), (tcfg, tm, tp), _ = greedy_pair
    feats = np.random.default_rng(4).standard_normal((3, 4, 12)).astype(
        np.float32)
    caps = ["a dog runs", "a cat", "two people"]
    a = JaxServer(jcfg, jp, jm, _source(JaxSource).vocab).run_batch(feats,
                                                                    caps)
    server = CaptionServer(tcfg, tp, tm, _source(SyntheticCaptionSource)
                           .vocab, device="cpu")
    assert server.run_batch(feats, caps) == a
    out = io.StringIO()
    served = serve_stream(server, io.StringIO("\n".join(_requests(5)) + "\n"),
                          out)
    assert served == 5


def test_cli_serves_editnet_greedy(greedy_pair, monkeypatch, capsys):
    """``serve --config editnet_greedy --device cpu``: the same lines as
    the JAX CLI on the same weights."""
    _, _, path = greedy_pair
    sets = [a for k, v in SERVE.items() if not k.startswith("decode.batch")
            for a in ("--set", f"{k}={v}")]
    argv = ["serve", "--config", "editnet_greedy", "--synthetic", "--params",
            path, "--batch", "4", "--ladder", "1", *sets]
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
