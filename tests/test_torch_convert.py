"""The port's checkpoint converter (``captionkit_torch.convert``) against
the reference's (``captionkit.convert``) on the same torch twins.

The converted arrays are bit-equal to the file the reference's converter
writes, name for name; the converted port model reproduces the twin's
step logits (within 1e-4 at fp32), its greedy captions exactly and its
beam captions; ``fit_names`` fits the same layouts as the reference's on
the same shape dicts. A pickled twin loads without importing JAX.
"""

import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from captionkit.convert import fit_names as jfit
from captionkit.convert import torch_import as jimport
from captionkit.convert import torch_ref as jref
from captionkit.train.checkpoint import save_params_npz as jax_save_npz

from captionkit_torch.config import ModelConfig
from captionkit_torch.convert import fit_names as tfit
from captionkit_torch.convert import torch_import as timport
from captionkit_torch.convert.torch_ref import (
    TorchDCNet,
    TorchEditNet,
    beam_search_slow,
)
from captionkit_torch.decode import beam_search, greedy_decode
from captionkit_torch.models import get_model
from captionkit_torch.params import params_to_numpy

REPO = Path(__file__).resolve().parent.parent
V, E, H, A, F, R = 40, 12, 16, 8, 10, 4
START, END = 2, 3

TWINS = {
    "editnet": lambda: TorchEditNet(V, E, H, A, F),
    "dcnet": lambda: TorchDCNet(V, E, H, A),
    "dcnet_visual": lambda: TorchDCNet(V, E, H, A, use_visual=True, feat=F),
}


def _twin(kind, seed=0):
    torch.manual_seed(seed)
    return TWINS[kind]().eval()


def _arch(kind):
    return "editnet" if kind == "editnet" else "dcnet"


def _mcfg(kind, **over):
    return ModelConfig(arch=_arch(kind), vocab_size=V, emb_dim=E,
                       hidden_dim=H, att_dim=A, feat_dim=F, num_regions=R,
                       dropout=0.0, compute_dtype="float32",
                       dcnet_use_visual=kind == "dcnet_visual", **over)


def _data(batch=3, t_in=6, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((batch, R, F)).astype(np.float32)
    existing = rng.integers(4, V, (batch, t_in)).astype(np.int64)
    lengths = rng.integers(2, t_in + 1, (batch,)).astype(np.int64)
    return feats, existing, lengths


def _reference_arrays(sd, arch, tmp_path):
    """The reference converter's output file, read back."""
    params = jimport.params_from_state_dict(sd, arch)
    path = tmp_path / f"ref_{arch}.npz"
    jax_save_npz(params, str(path))
    with np.load(path) as z:
        return {n: z[n] for n in z.files}


@pytest.mark.parametrize("kind", sorted(TWINS))
def test_converted_arrays_equal_the_reference_file(kind, tmp_path):
    twin = _twin(kind)
    # The copied twin draws the reference twin's weights for one seed.
    torch.manual_seed(0)
    jtwin = {"editnet": lambda: jref.TorchEditNet(V, E, H, A, F),
             "dcnet": lambda: jref.TorchDCNet(V, E, H, A),
             "dcnet_visual": lambda: jref.TorchDCNet(
                 V, E, H, A, use_visual=True, feat=F)}[kind]()
    for (n1, t1), (n2, t2) in zip(twin.state_dict().items(),
                                  jtwin.state_dict().items()):
        assert n1 == n2 and torch.equal(t1, t2), n1
    sd = twin.state_dict()
    got = params_to_numpy(timport.params_from_state_dict(
        sd, _arch(kind), device="cpu"))
    want = _reference_arrays(sd, _arch(kind), tmp_path)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype == np.float32, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_missing_and_extra_keys_raise():
    sd = dict(_twin("editnet").state_dict())
    sd.pop("fc.bias")
    for conv in (jimport.editnet_params_from_state_dict,
                 lambda raw: timport.editnet_params_from_state_dict(
                     raw, device="cpu")):
        with pytest.raises(KeyError, match="missing"):
            conv(sd)
    sd2 = dict(_twin("dcnet").state_dict())
    sd2["rogue.weight"] = torch.zeros(3)
    for conv in (jimport.dcnet_params_from_state_dict,
                 lambda raw: timport.dcnet_params_from_state_dict(
                     raw, device="cpu")):
        with pytest.raises(ValueError, match="unconverted"):
            conv(sd2)
    # Ignored prefixes are exempt from exhaustion, as in the reference.
    params = timport.dcnet_params_from_state_dict(
        sd2, {"__ignore_prefixes__": ["rogue."]}, device="cpu")
    assert params.vis_attention is None
    with pytest.raises(KeyError, match="unknown entries"):
        timport.resolve_name_map("editnet", {"not_a_component": "x"})


def _rename(sd, mapping, prefix=""):
    out = {}
    for k, v in sd.items():
        for old, new in mapping.items():
            if k.startswith(old + "."):
                k = new + k[len(old):]
                break
        out[prefix + k] = v
    return out


def test_alternate_layout_converts_through_a_name_map(tmp_path):
    sd = _twin("editnet").state_dict()
    alt = _rename(sd, {"f_beta": "beta_gate", "scma": "select_att",
                       "lang_lstm": "copy_lstm"}, prefix="decoder.")
    override = {"__strip_prefix__": "decoder.", "vis_gate": "beta_gate",
                "scma": "select_att", "lang_lstm": "copy_lstm"}
    got = params_to_numpy(timport.editnet_params_from_state_dict(
        alt, override, device="cpu"))
    want = _reference_arrays(sd, "editnet", tmp_path)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    with pytest.raises(KeyError, match="missing"):
        timport.editnet_params_from_state_dict(alt, device="cpu")


def _encode_both(kind, twin, model, params, feats, existing, lengths):
    f, ex, ln = (torch.from_numpy(a) for a in (feats, existing, lengths))
    with torch.no_grad():
        if kind == "editnet":
            tctx = twin.encode(f, ex, ln)
        elif kind == "dcnet":
            tctx = twin.encode(ex, ln)
        else:
            tctx = twin.encode(ex, ln, f)
    ctx = model.encode(params, None if kind == "dcnet" else f, ex, ln)
    return tctx, ctx


@pytest.mark.parametrize("kind", sorted(TWINS))
def test_stepwise_logits_match_the_twin(kind):
    twin = _twin(kind, seed=1)
    params = timport.params_from_state_dict(twin.state_dict(), _arch(kind),
                                            device="cpu")
    model = get_model(_mcfg(kind))
    feats, existing, lengths = _data(seed=3)
    tctx, ctx = _encode_both(kind, twin, model, params, feats, existing,
                             lengths)
    tstate = list(twin.init_state(tctx))
    state = model.init_state(params, ctx)
    tok = torch.full((3,), START, dtype=torch.long)
    with torch.no_grad():
        for _ in range(5):
            out = twin.step(tctx, *tstate, tok)
            tstate, tlogits = list(out[:-1]), out[-1]
            state, logits = model.step(params, ctx, state,
                                       tok.to(torch.int32))
            torch.testing.assert_close(logits, tlogits, atol=1e-4, rtol=0)
            tok = tlogits.argmax(-1)


@pytest.mark.parametrize("kind", ["editnet", "dcnet"])
def test_greedy_identical_and_beam_matches_the_slow_beam(kind):
    twin = _twin(kind, seed=2)
    params = timport.params_from_state_dict(twin.state_dict(), _arch(kind),
                                            device="cpu")
    model = get_model(_mcfg(kind))
    feats, existing, lengths = _data(batch=5, seed=5)
    _, ctx = _encode_both(kind, twin, model, params, feats, existing,
                          lengths)
    greedy = greedy_decode(model, params, ctx, start_id=START, end_id=END,
                           max_len=12).tokens.numpy()
    beam = beam_search(model, params, ctx, beam_size=5, start_id=START,
                       end_id=END, max_len=12).tokens.numpy()
    from captionkit_torch.convert.gate import _twin_greedy

    twin_greedy = _twin_greedy(twin, kind, feats, existing, lengths,
                               start_id=START, end_id=END, max_len=12)
    for b in range(5):
        ref = twin_greedy[b]
        assert greedy[b][:len(ref)].tolist() == ref, b
        slow = beam_search_slow(
            twin, None if kind == "dcnet" else torch.from_numpy(
                feats[b:b + 1]),
            torch.from_numpy(existing[b:b + 1]),
            torch.from_numpy(lengths[b:b + 1]),
            beam_size=5, start_id=START, end_id=END, max_len=12)
        assert beam[b][:len(slow)].tolist() == slow, b


# ------------------------------------------------------------ fit_names

SCRAMBLE_EDITNET = {
    "embedding": "blk0", "encoder": "blk1", "att_lstm": "blk2",
    "vis_attention": "blk3", "f_beta": "blk4", "scma": "blk5",
    "lang_lstm": "blk6", "fc": "blk7",
}


def _rename_longest(sd, module_map):
    out = {}
    for k, v in sd.items():
        nk = k
        for old, new in sorted(module_map.items(), key=lambda x: -len(x[0])):
            if nk == old or nk.startswith(old + "."):
                nk = new + nk[len(old):]
                break
        out[nk] = v
    return out


def _fit_cases():
    """(name, arch, raw state dict, ModelConfig dims): the layouts of
    tests/test_fit_names.py."""
    cases = []
    torch.manual_seed(0)
    ed = TorchEditNet(V, E, H, A, F).eval().state_dict()
    cases.append(("scrambled_modules", "editnet",
                  _rename_longest(ed, SCRAMBLE_EDITNET), {}))
    leaf_junk = {
        "vis_attention.encoder_att": "blk3.u0",
        "vis_attention.decoder_att": "blk3.u1",
        "vis_attention.full_att": "blk3.u2",
        "scma.encoder_att": "blk5.u0", "scma.decoder_att": "blk5.u1",
        "scma.full_att": "blk5.u2", "lang_lstm.weight_rx": "blk6.p0",
        "lang_lstm.weight_rh": "blk6.p1", "lang_lstm.weight_rc": "blk6.p2",
        "lang_lstm.bias_r": "blk6.p3", "lang_lstm.base": "blk6.cell",
        **SCRAMBLE_EDITNET,
    }
    cases.append(("fully_scrambled", "editnet",
                  _rename_longest(ed, leaf_junk), {}))
    torch.manual_seed(2)
    tied = TorchEditNet(V, H, H, A, F).eval().state_dict()
    cases.append(("emb_eq_hidden_tied", "editnet",
                  _rename_longest(tied, SCRAMBLE_EDITNET), {"emb_dim": H}))
    lstm_leaf = {(k.replace("encoder.", "rnn.") + "_l0"
                  if k.startswith("encoder.") else k): v
                 for k, v in tied.items()}
    cases.append(("nn_lstm_leaves", "editnet", lstm_leaf, {"emb_dim": H}))
    torch.manual_seed(1)
    dc = TorchDCNet(V, E, H, A).eval().state_dict()
    cases.append(("dcnet_fully_scrambled", "dcnet", _rename_longest(dc, {
        "embedding": "m0", "encoder": "m1",
        "attention.encoder_att": "m2.u0", "attention.decoder_att": "m2.u1",
        "attention.full_att": "m2.u2", "attention": "m2", "f_beta": "m3",
        "decode_step": "m4", "init_h": "m5", "init_c": "m6", "fc": "m7"}),
        {}))
    extra = dict(dc)
    extra["opt.step_buf"] = torch.zeros(7, 3)
    cases.append(("dcnet_extra_keys", "dcnet", extra, {}))
    torch.manual_seed(9)
    vis = TorchDCNet(V, E, H, A, use_visual=True, feat=F).eval()
    cases.append(("dcnet_visual", "dcnet", _rename_longest(
        vis.state_dict(), {"embedding": "w0", "encoder": "w1",
                           "attention": "w2", "f_beta": "w3",
                           "decode_step": "w4", "init_h": "w5",
                           "init_c": "w6", "fc": "w7",
                           "vis_attention": "w8"}),
        {"dcnet_use_visual": True}))
    rng = random.Random(42)
    for trial in range(6):
        e = rng.choice([8, 12, 16])
        hdim = rng.choice([8, 16])
        a = rng.choice([4, 8])
        f = rng.choice([hdim, 10, 20])
        v = rng.randint(30, 60)
        torch.manual_seed(100 + trial)
        tw = TorchEditNet(v, e, hdim, a, f).eval()
        names = {m: f"sub{rng.randint(0, 9)}_{i}" for i, m in
                 enumerate(SCRAMBLE_EDITNET)}
        cases.append((f"fuzz{trial}", "editnet",
                      _rename_longest(tw.state_dict(), names),
                      dict(vocab_size=v, emb_dim=e, hidden_dim=hdim,
                           att_dim=a, feat_dim=f)))
    return cases


FIT_CASES = _fit_cases()


@pytest.mark.parametrize("case", FIT_CASES, ids=[c[0] for c in FIT_CASES])
def test_fit_names_fits_as_the_reference(case, tmp_path):
    from captionkit.utils.config import ModelConfig as JaxModelConfig

    _, arch, raw, over = case
    dims = dict(vocab_size=V, emb_dim=E, hidden_dim=H, att_dim=A,
                feat_dim=F, num_regions=R, dropout=0.0,
                compute_dtype="float32")
    dims.update(over)
    shapes = tfit.state_dict_shapes(raw)
    assert shapes == jfit.state_dict_shapes(raw)
    got = tfit.fit_translation(shapes, arch, ModelConfig(arch=arch, **dims))
    want = jfit.fit_translation(shapes, arch,
                                JaxModelConfig(arch=arch, **dims))
    assert got.translation == want.translation
    assert got.alternates == want.alternates
    assert got.notes == want.notes
    assert got.unmatched_raw == want.unmatched_raw
    try:
        want_dims = jfit.infer_dims(shapes, arch)
    except jfit.FitError as e:
        with pytest.raises(tfit.FitError, match=str(e)[:20]):
            tfit.infer_dims(shapes, arch)
    else:
        assert tfit.infer_dims(shapes, arch) == want_dims
    # The best fit converts to the reference's arrays.
    params, _ = tfit.fit_params_from_state_dict(
        raw, arch, ModelConfig(arch=arch, **dims), device="cpu")
    ref = _reference_arrays(
        jfit.translate_state_dict(raw, want.translation), arch, tmp_path)
    got_arrays = params_to_numpy(params)
    assert sorted(got_arrays) == sorted(ref)
    for name in ref:
        np.testing.assert_array_equal(got_arrays[name], ref[name])


def test_fit_names_wrong_dims_raise():
    shapes = tfit.state_dict_shapes(_twin("dcnet").state_dict())
    bad = ModelConfig(arch="dcnet", vocab_size=V + 5, emb_dim=E,
                      hidden_dim=H, att_dim=A, feat_dim=F, num_regions=R)
    with pytest.raises(tfit.FitError):
        tfit.fit_translation(shapes, "dcnet", bad)


def test_pickled_twin_loads_without_jax(tmp_path):
    """A training dict whose ``decoder`` is the port's pickled twin (the
    released checkpoints' layout) loads in a process that imports no JAX
    and nothing of ``captionkit``."""
    twin = _twin("editnet")
    path = tmp_path / "BEST_checkpoint.pth.tar"
    torch.save({"epoch": 3, "decoder": twin, "bleu-4": 0.1}, path)
    want = {k: v.numpy() for k, v in twin.state_dict().items()}
    np.savez(tmp_path / "want.npz", **want)
    code = (
        "import sys, numpy as np\n"
        "from captionkit_torch.convert.torch_import import "
        "load_torch_state_dict, params_from_state_dict\n"
        f"raw = load_torch_state_dict({str(path)!r})\n"
        f"want = np.load({str(tmp_path / 'want.npz')!r})\n"
        "assert sorted(raw) == sorted(want.files)\n"
        "assert all(np.array_equal(raw[k].numpy(), want[k]) for k in raw)\n"
        "params_from_state_dict(raw, 'editnet', device='cpu')\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'captionkit')"
        " or m.startswith(('jax.', 'jaxlib', 'flax.', 'captionkit.'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]
