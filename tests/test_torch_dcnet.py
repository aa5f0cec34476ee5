"""The port's DCNet (``captionkit_torch.models.dcnet``) against
``captionkit.models.dcnet`` on the CPU, on the same weights (JAX init,
carried over by the flat-name bridge) and the same numpy inputs; its
weight bridge; and DCNet serving through ``CaptionServer`` and the CLI.

Tolerances: fp32 atol 1e-4 (the same fp32 products summed in other
orders through a few layers); bf16 atol 1e-3 (both sides round the same
operands at the same places; a value within an ulp of a bf16 rounding
boundary may round the other way). Top-k indices must be equal.
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
from captionkit.models import get_model as jax_get_model
from captionkit.serve import CaptionServer as JaxServer
from captionkit.serve import serve_stream as jax_serve_stream
from captionkit.train.checkpoint import load_params_npz as jax_load_npz
from captionkit.train.checkpoint import save_params_npz as jax_save_npz
from captionkit.utils.config import CaptionKitConfig as JaxConfig
from captionkit.utils.config import ModelConfig as JaxModelConfig

from captionkit_torch import cli
from captionkit_torch import params as bridge
from captionkit_torch.config import CaptionKitConfig, ModelConfig
from captionkit_torch.data import SyntheticCaptionSource
from captionkit_torch.models import get_model
from captionkit_torch.serve import CaptionServer, serve_stream

SMALL = dict(vocab_size=120, emb_dim=16, hidden_dim=24, att_dim=8,
             feat_dim=12, num_regions=5, dropout=0.0)
ATOL = {"float32": 1e-4, "bfloat16": 1e-3}


def _flat(jp):
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    return {"/".join(str(getattr(k, "name", k)) for k in path):
            np.asarray(leaf) for path, leaf in flat if leaf is not None}


def _models(dtype="float32", **kw):
    cfg = dict(SMALL, arch="dcnet", compute_dtype=dtype, **kw)
    jm = jax_get_model(JaxModelConfig(**cfg))
    tm = get_model(ModelConfig(**cfg))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tm, bridge.dcnet_params_from_numpy(_flat(jp), "cpu")


def _inputs(B=3, T=6, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, SMALL["num_regions"],
                                 SMALL["feat_dim"])).astype(np.float32)
    ex = rng.integers(4, SMALL["vocab_size"], (B, T)).astype(np.int32)
    ln = np.array([T, 2, 4][:B], np.int32)
    return feats, ex, ln


def _encode(jm, jp, tm, tp, feats, ex, ln):
    jctx = jm.encode(jp, jnp.asarray(feats), jnp.asarray(ex), jnp.asarray(ln))
    tctx = tm.encode(tp, torch.from_numpy(feats), torch.from_numpy(ex).long(),
                     torch.from_numpy(ln).long())
    return jctx, tctx


def _close(j, t, atol, msg=""):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=0, err_msg=msg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("visual", [False, True])
def test_encode_matches(dtype, visual):
    jm, jp, tm, tp = _models(dtype, dcnet_use_visual=visual)
    jctx, tctx = _encode(jm, jp, tm, tp, *_inputs())
    fields = ["enc_hs", "att_keys", "h0", "c0"]
    if visual:
        fields += ["features", "vis_keys"]
    else:
        assert tctx.features is None and tctx.vis_keys is None
    for f in fields:
        j, t = getattr(jctx, f), getattr(tctx, f)
        assert tuple(t.shape) == tuple(j.shape), f
        assert str(t.dtype).split(".")[-1] == str(j.dtype), f
        _close(j, t, ATOL[dtype], f)
    assert tctx.mask.tolist() == np.asarray(jctx.mask).tolist()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("visual", [False, True])
def test_step_logits_teacher_forced_and_step_topk(dtype, visual):
    """Three teacher-forced steps from the same tokens: logits, state and
    the fused head's top-k all match, beam-expanded (grouped queries)."""
    K = 3
    jm, jp, tm, tp = _models(dtype, dcnet_use_visual=visual)
    jctx, tctx = _encode(jm, jp, tm, tp, *_inputs())
    jctx, tctx = jm.beam_expand(jctx, K), tm.beam_expand(tctx, K)
    jstate, tstate = jm.init_state(jp, jctx), tm.init_state(tp, tctx)
    jctx_k, tctx_k = jm.prepare_topk(jp, jctx, K), tm.prepare_topk(tp, tctx, K)
    atol = ATOL[dtype]
    rng = np.random.default_rng(1)
    for t in range(3):
        tok = rng.integers(0, SMALL["vocab_size"], (3 * K,)).astype(np.int32)
        jtok, ttok = jnp.asarray(tok), torch.from_numpy(tok).long()
        js1, jlogits = jm.step(jp, jctx, jstate, jtok)
        ts1, tlogits = tm.step(tp, tctx, tstate, ttok)
        _close(jlogits, tlogits, atol, f"logits step {t}")
        _close(js1.h, ts1.h, atol)
        _close(js1.c, ts1.c, atol)
        js2, jv, ji, jl = jm.step_topk(jp, jctx_k, jstate, jtok, K)
        ts2, tv, ti, tl = tm.step_topk(tp, tctx_k, tstate, ttok, K)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        _close(jv, tv, atol)
        _close(jl, tl, atol)
        _close(js2.h, ts2.h, atol)
        jstate, tstate = js1, ts1


@pytest.mark.parametrize("cell_impl", ["xla", "pallas"])
def test_beam_decode_identical_to_jax(cell_impl):
    from captionkit.decode.beam import beam_search as jax_beam_search

    from captionkit_torch.decode.beam import beam_search

    jm, jp, tm, tp = _models(cell_impl=cell_impl)
    jctx, tctx = _encode(jm, jp, tm, tp, *_inputs(B=3, seed=4))
    kw = dict(beam_size=5, start_id=2, end_id=3, max_len=8)
    j = jax_beam_search(jm, jp, jctx, impl="register", **kw)
    t = beam_search(tm, tp, tctx, **kw)
    np.testing.assert_array_equal(t.all_tokens.numpy(),
                                  np.asarray(j.all_tokens))
    np.testing.assert_allclose(t.all_scores.numpy(), np.asarray(j.all_scores),
                               atol=1e-4, rtol=0)


def test_visual_config_keeps_plain_cells():
    """cell_impl="pallas" with the visual head builds no pack, as in the
    reference: its step is the plain one."""
    _, _, tm, tp = _models(dcnet_use_visual=True, cell_impl="pallas")
    feats, ex, ln = _inputs()
    ctx = tm.encode(tp, torch.from_numpy(feats), torch.from_numpy(ex).long(),
                    torch.from_numpy(ln).long())
    assert tm.prepare_topk(tp, ctx, 5).cell_pack is None


@pytest.mark.parametrize("visual", [False, True])
def test_npz_round_trip_is_exact(tmp_path, visual):
    jm = jax_get_model(JaxModelConfig(arch="dcnet", dcnet_use_visual=visual,
                                      **SMALL))
    jp = jm.init(jax.random.PRNGKey(3))
    jax_save_npz(jp, str(tmp_path / "jax.npz"))
    tp = bridge.load_params_npz(str(tmp_path / "jax.npz"), "cpu",
                                arch="dcnet")
    assert (tp.vis_attention is not None) == visual
    ref = _flat(jp)
    got = bridge.params_to_numpy(tp)
    names = bridge.DCNET_NAMES + (bridge.DCNET_VISUAL_NAMES if visual
                                  else ())
    assert sorted(got) == sorted(ref) == sorted(names)
    for name in ref:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    bridge.save_params_npz(tp, str(tmp_path / "torch.npz"))
    back = _flat(jax_load_npz(jp, str(tmp_path / "torch.npz")))
    for name in ref:
        np.testing.assert_array_equal(back[name], ref[name], err_msg=name)
    with pytest.raises(ValueError, match="dcnet"):
        bridge.load_params_npz(str(tmp_path / "torch.npz"), "cpu",
                               arch="editnet")


def test_missing_name_raises():
    arrays = {n: np.zeros((1,), np.float32) for n in bridge.DCNET_NAMES}
    del arrays["init_c_w"]
    with pytest.raises(KeyError, match="init_c_w"):
        bridge.dcnet_params_from_numpy(arrays, "cpu")
    arrays = {n: np.zeros((1,), np.float32) for n in bridge.DCNET_NAMES}
    arrays["vis_attention/w_q"] = np.zeros((1,), np.float32)
    with pytest.raises(KeyError, match="vis_attention/w_enc"):
        bridge.dcnet_params_from_numpy(arrays, "cpu")


SERVE = {
    "model.arch": "dcnet", "model.emb_dim": 16, "model.hidden_dim": 24,
    "model.att_dim": 8, "model.feat_dim": 12, "model.num_regions": 4,
    "model.dropout": 0.0, "decode.beam_size": 3, "decode.max_decode_len": 8,
    "decode.batch_size": 4, "data.max_existing_len": 12,
}


def _source(cls):
    return cls(num_images=2, captions_per_image=1, num_regions=4,
               feat_dim=12, max_len=12, seed=0)


def _requests(n, seed=0):
    rng = np.random.default_rng(seed)
    caps = ["a dog runs", "a man riding a horse", "two people"]
    return [json.dumps({"id": i, "caption": caps[i % 3],
                        "features_inline": rng.standard_normal((4, 12))
                        .round(3).tolist()}) for i in range(n)]


@pytest.mark.parametrize("cell_impl", ["xla", "pallas"])
def test_server_same_captions_as_jax(tmp_path, cell_impl):
    vocab = _source(SyntheticCaptionSource).vocab
    over = dict(SERVE, **{"model.vocab_size": len(vocab),
                          "model.cell_impl": cell_impl})
    jcfg = JaxConfig().override(over)
    jm = jax_get_model(jcfg.model)
    jp = jm.init(jax.random.PRNGKey(0))
    jax_save_npz(jp, str(tmp_path / "p.npz"))
    tcfg = CaptionKitConfig().override(over)
    tp = bridge.load_params_npz(str(tmp_path / "p.npz"), "cpu")
    server = CaptionServer(tcfg, tp, get_model(tcfg.model), vocab,
                           ladder=(2,), device="cpu")
    jax_server = JaxServer(jcfg, jp, jm, _source(JaxSource).vocab,
                           ladder=(2,))
    lines = _requests(6) + [json.dumps({"flush": True})] + _requests(1, 1)
    outs = []
    for fn, srv in ((jax_serve_stream, jax_server), (serve_stream, server)):
        out = io.StringIO()
        fn(srv, io.StringIO("\n".join(lines) + "\n"), out)
        outs.append([json.loads(x) for x in out.getvalue().splitlines()])
    assert outs[1] == outs[0]
    answers = [r for r in outs[1] if "caption" in r]
    assert [r["id"] for r in answers] == list(range(6)) + [0]


def test_cli_serve_dcnet_pallas_same_output_as_jax_cli(tmp_path, monkeypatch,
                                                       capsys):
    vocab = _source(SyntheticCaptionSource).vocab
    over = dict(SERVE, **{"model.vocab_size": len(vocab)})
    jm = jax_get_model(JaxConfig().override(over).model)
    path = str(tmp_path / "p.npz")
    jax_save_npz(jm.init(jax.random.PRNGKey(0)), path)
    sets = [a for k, v in SERVE.items()
            if k not in ("decode.batch_size", "model.arch")
            for a in ("--set", f"{k}={v}")]
    argv = ["serve", "--config", "dcnet_beam5", "--synthetic", "--params",
            path, "--batch", "4", "--ladder", "1", *sets,
            "--set", "model.cell_impl=pallas"]
    stdin = "\n".join(_requests(5)) + "\n"
    outs = []
    for main, args in ((jax_cli.main, ["--platform", "cpu", *argv]),
                       (cli.main, [*argv, "--device", "cpu"])):
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
        assert main(args) == 0
        outs.append(capsys.readouterr().out.splitlines())
    assert outs[1] == outs[0]
    assert len(outs[1]) == 6


def test_cli_serve_dcnet_random_weights(monkeypatch, capsys):
    """``serve --config dcnet_beam5 --synthetic --device cpu`` answers
    with random weights from --seed (no checkpoint)."""
    sets = [a for k, v in SERVE.items()
            if k not in ("decode.batch_size", "model.arch")
            for a in ("--set", f"{k}={v}")]
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "\n".join(_requests(3)) + "\n"))
    assert cli.main(["serve", "--config", "dcnet_beam5", "--synthetic",
                     "--batch", "4", "--device", "cpu", *sets]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0]["ready"] is True
    assert [r["id"] for r in lines[1:]] == [0, 1, 2]
    assert all(isinstance(r["caption"], str) for r in lines[1:])


def test_unported_dcnet_options_raise():
    """DCNet with ``cell_impl="wholestep"`` builds and, as in the
    reference, keeps the plain cells: ``prepare_topk`` builds no cell pack
    and its step equals the plain model's. ``impl="backptr"`` beam search,
    ported since, gives the register layout's result."""
    from captionkit_torch.decode.beam import beam_search

    jm, jp, tm, tp = _models()
    ws = get_model(ModelConfig(**dict(SMALL, arch="dcnet",
                                      compute_dtype="float32",
                                      cell_impl="wholestep")))
    feats, ex, ln = _inputs()
    _, ctx = _encode(jm, jp, tm, tp, feats, ex, ln)
    ctx_k = ws.prepare_topk(tp, ws.beam_expand(ctx, 2), 2)
    assert ctx_k.cell_pack is None
    state = ws.init_state(tp, ctx_k)
    tok = torch.arange(6)
    got = ws.step_topk(tp, ctx_k, state, tok, 2)
    want = tm.step_topk(tp, tm.prepare_topk(tp, tm.beam_expand(ctx, 2), 2),
                        state, tok, 2)
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    bp, reg = (beam_search(ws, tp, ctx, beam_size=2, start_id=2, end_id=3,
                           impl=impl) for impl in ("backptr", "register"))
    for f in bp._fields:
        assert torch.equal(getattr(bp, f), getattr(reg, f)), f
    # The int8 head (with its DCNet warning) and thresh extraction build.
    with pytest.warns(UserWarning, match="head_quant='int8' with "
                                         "arch='dcnet'"):
        cfg = ModelConfig(arch="dcnet", head_quant="int8")
    assert get_model(cfg).name == "dcnet"
    assert get_model(ModelConfig(arch="dcnet",
                                 head_extract="thresh")).name == "dcnet"