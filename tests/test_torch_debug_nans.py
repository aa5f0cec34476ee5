"""``--debug-nans`` in the port (``captionkit_torch.utils.logging``) against
the reference's ``jax_debug_nans`` on the CPU.

The raise matrix runs the reference's CLI (``captionkit.cli.main``) and the
port's (``captionkit_torch.cli.main``) in-process on one tiny prepared split
(8 train and 4 test images, emb/hidden 32, att 16; an existing caption of
0 words in train and of 1 word in test; the named configs' bf16 compute)
and the same ``.npz`` files, each case with ``--debug-nans`` before the
subcommand. The reference's column below is what its CLI did when the
table was written; the test holds both packages to it. Where a case
raises, the port must raise ``FloatingPointError`` from the counterpart
of the reference's raising call: the chain of package frames between the
CLI and the raise (function names, module paths without the package
name) must be the start of the reference's chain, whose tail may go on
into the op-by-op re-run JAX makes of a jitted call that produced a NaN.

Reference column, measured (JAX 0.9.0, CPU):

* ``decode`` (beam; greedy; ``decode-stacked``): never raises, with a NaN
  in a head weight, an att-LSTM weight or an image's features. The
  decode's jitted call returns int tokens only, and nothing eager touches
  a weight or a feature before it (``load_params_npz`` is a plain
  ``asarray``, the feed's casts are numpy's).
* ``decode --params a.npz,b.npz``: raises in ``stack_params``, whose eager
  ``jnp.stack`` of the members checks every member's weights.
* ``train-xe``: raises in the k-step pack (``multi_fn``, a ``lax.scan``)
  with a NaN in a weight or in one image's features: the pack's outputs
  hold the updated weights.
* ``train-scst --params``: raises in the update (``step_fn``), not in the
  rollout, whose outputs are tokens and 0/1 masks.
* No plant: nothing raises; the masked steps of the captions of 0 and 1
  words leave no NaN in any output.
"""

import contextlib
import io
import json
import traceback

import jax
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import captionkit.cli as jax_cli
import captionkit.train as jax_train
from captionkit.data.prepare import prepare_from_karpathy as j_prepare
from captionkit.models import get_model as jax_get_model
from captionkit.train.checkpoint import save_params_npz as jax_save_npz
from captionkit.utils.config import ModelConfig as JaxModelConfig

import captionkit_torch.train.state as t_state
from captionkit_torch import cli
from captionkit_torch.config import ModelConfig, TrainConfig
from captionkit_torch.data.prepare import load_prepared_split
from captionkit_torch.models import get_model
from captionkit_torch.models.ensemble import stack_params
from captionkit_torch.params import named_tensors
from captionkit_torch.train import xe as t_xe
from captionkit_torch.train.state import create_train_state, trainable
from captionkit_torch.utils.logging import (
    check_nans,
    debug_nans,
    enable_nan_debugging,
    nan_debugging_enabled,
)

R, F = 5, 12
SMALL = dict(emb_dim=32, hidden_dim=32, att_dim=16, feat_dim=F,
             num_regions=R)
WORDS = ("a man woman dog cat rides holds runs sits near on in the park "
         "beach bench horse red blue small").split()
SETS = {**{f"model.{k}": v for k, v in SMALL.items()},
        "decode.beam_size": 3, "decode.batch_size": 8,
        "decode.max_decode_len": 10, "data.batch_size": 8,
        "train.steps_per_dispatch": 3}


@pytest.fixture(autouse=True)
def _flags_restored():
    """No test may leave either package's flag on for the next test."""
    yield
    assert not nan_debugging_enabled()
    assert not jax.config.jax_debug_nans


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """Two prepared copies of one split (the reference's prepare), ``p``
    and ``pnan`` (one NaN in image 1's features of each split), and the
    ``.npz`` files: EditNet ``ed``, ``ed2``, DCNet ``dc`` (JAX inits) and
    copies with one NaN in ``fc_w`` or ``att_lstm/wx``."""
    tmp = tmp_path_factory.mktemp("nans")
    rng = np.random.default_rng(0)
    images, existing = [], {"train": [], "test": []}
    for i, part in enumerate(["train"] * 8 + ["test"] * 4):
        caps = [[WORDS[j] for j in rng.integers(0, len(WORDS),
                                                int(rng.integers(1, 8)))]
                for _ in range(5)]
        images.append({"split": part, "cocoid": 100 + i,
                       "sentences": [{"tokens": c} for c in caps]})
        words = {0: [], 8: ["dog"]}.get(i, caps[1][1:])
        existing[part].append({"image_id": 100 + i,
                               "caption": " ".join(words)})
    (tmp / "k.json").write_text(json.dumps({"images": images}))
    epaths = {}
    for part, rows in existing.items():
        epaths[part] = str(tmp / f"ex_{part}.json")
        (tmp / f"ex_{part}.json").write_text(json.dumps(rows))
    feats = {part: rng.standard_normal((n, R, F)).astype(np.float32)
             for part, n in (("train", 8), ("test", 4))}
    for name in ("p", "pnan"):
        fpaths = {}
        for part, a in feats.items():
            a = a.copy()
            if name == "pnan":
                a[1, 2, 3] = np.nan
            fpaths[part] = str(tmp / f"f_{name}_{part}.npy")
            np.save(fpaths[part], a)
        j_prepare(karpathy_json=str(tmp / "k.json"),
                  output_dir=str(tmp / name), existing_captions=epaths,
                  features=fpaths, min_word_freq=1)
    V = len(load_prepared_split(str(tmp / "p"), "test").vocab)
    out = {"dir": tmp}
    for name, arch, seed in (("ed", "editnet", 0), ("ed2", "editnet", 1),
                             ("dc", "dcnet", 2)):
        m = jax_get_model(JaxModelConfig(arch=arch, vocab_size=V, **SMALL))
        out[name] = str(tmp / f"{name}.npz")
        jax_save_npz(m.init(jax.random.PRNGKey(seed)), out[name])
    for name, src, key in (("ed_head", "ed", "fc_w"),
                           ("ed_att", "ed", "att_lstm/wx"),
                           ("ed2_head", "ed2", "fc_w")):
        arrays = dict(np.load(out[src]))
        arrays[key] = arrays[key].copy()
        arrays[key].flat[3] = np.nan
        out[name] = str(tmp / f"{name}.npz")
        np.savez(out[name], **arrays)
    return out


def _sets():
    return [a for k, v in SETS.items() for a in ("--set", f"{k}={v}")]


def _decode(s, config, params, prep="p"):
    return ["decode", "--config", config, "--prepared", str(s["dir"] / prep),
            "--split", "test", "--params", params, *_sets(), "--no-metrics"]


def _train(s, kind, prep="p", params=None):
    argv = [kind, "--config", "xe_train" if kind == "train-xe"
            else "scst_train", "--prepared", str(s["dir"] / prep), "--split",
            "train", *_sets(), "--max-steps", "3", "--no-val", "--set",
            f"train.checkpoint_dir={s['dir'] / ('ck_' + kind + prep)}"]
    return argv + (["--params", s[params]] if params else [])


# case: (argv from the split's fixture, a planted train-xe weight, the
# reference raises, the start of the port's message after "in ")
MATRIX = {
    "decode_beam/none": (lambda s: _decode(s, "editnet_beam5", s["ed"]),
                         False, False, None),
    "decode_beam/head_weight": (
        lambda s: _decode(s, "editnet_beam5", s["ed_head"]),
        False, False, None),
    "decode_beam/att_lstm_weight": (
        lambda s: _decode(s, "editnet_beam5", s["ed_att"]),
        False, False, None),
    "decode_beam/features": (
        lambda s: _decode(s, "editnet_beam5", s["ed"], "pnan"),
        False, False, None),
    "decode_greedy/head_weight": (
        lambda s: _decode(s, "editnet_greedy", s["ed_head"]),
        False, False, None),
    "decode_ensemble/head_weight": (
        lambda s: _decode(s, "editnet_beam5",
                          f"{s['ed']},{s['ed2_head']}"),
        False, True, "stack_params: members/1/fc_w"),
    "decode_stacked/editnet_head_weight": (
        lambda s: ["decode-stacked", "--config", "editnet_beam5",
                   "--prepared", str(s["dir"] / "p"), "--split", "test",
                   *_sets(), "--dcnet-params", s["dc"], "--editnet-params",
                   s["ed_head"], "--no-metrics"],
        False, False, None),
    "train_xe/none": (lambda s: _train(s, "train-xe"), False, False, None),
    "train_xe/weight": (lambda s: _train(s, "train-xe"), True, True,
                        "xe_train_multistep: state/params/"),
    "train_xe/features": (lambda s: _train(s, "train-xe", "pnan"), False,
                          True, "xe_train_multistep: state/params/"),
    "train_scst/none": (lambda s: _train(s, "train-scst", params="ed"),
                        False, False, None),
    "train_scst/weight": (
        lambda s: _train(s, "train-scst", params="ed_att"), False, True,
        "scst_update: state/params/"),
}


def _plant_jax(monkeypatch):
    """The reference's ``create_train_state`` with one NaN in
    ``att_lstm/wx``, set through numpy (an eager ``.at[].set`` would raise
    itself)."""
    real = jax_train.create_train_state

    def planted(init, cfg, **kw):
        st = real(init, cfg, **kw)

        def put(path, x):
            name = "/".join(str(getattr(k, "name", k)) for k in path)
            if name != "att_lstm/wx":
                return x
            a = np.array(x)
            a[0, 3] = np.nan
            return jax.numpy.asarray(a)

        return type(st)(params=jax.tree_util.tree_map_with_path(
            put, st.params), opt_state=st.opt_state, step=st.step,
            rng=st.rng)

    monkeypatch.setattr(jax_train, "create_train_state", planted)


def _plant_torch(monkeypatch):
    real = t_state.create_train_state

    def planted(init, cfg, **kw):
        st = real(init, cfg, **kw)
        with torch.no_grad():
            st.params.att_lstm.wx[0, 3] = float("nan")
        return st

    monkeypatch.setattr(t_state, "create_train_state", planted)


def _site(exc, package):
    """The package frames of ``exc``'s traceback between the CLI and the
    raise: (module path without the package, function)."""
    frames = []
    for f in traceback.extract_tb(exc.__traceback__):
        path = f.filename.replace("\\", "/")
        if f"/{package}/" not in path:
            continue
        rel = path.rsplit(f"/{package}/", 1)[1]
        if rel not in ("cli.py", "utils/logging.py"):
            frames.append((rel, f.name))
    return frames


def _run_reference(argv):
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            assert jax_cli.main(["--platform", "cpu", "--debug-nans",
                                 *argv]) == 0
    except FloatingPointError as e:
        return e
    finally:
        jax.config.update("jax_debug_nans", False)
    return None


def _run_port(argv):
    try:
        with debug_nans(False), contextlib.redirect_stdout(io.StringIO()):
            assert cli.main(["--debug-nans", *argv, "--device", "cpu"]) == 0
    except FloatingPointError as e:
        return e
    return None


@pytest.mark.parametrize("case", list(MATRIX))
def test_raise_matrix_matches_the_reference(split, case, monkeypatch):
    make_argv, plant_weight, raises, message = MATRIX[case]
    if plant_weight:
        _plant_jax(monkeypatch)
        _plant_torch(monkeypatch)
    want = _run_reference(make_argv(split))
    got = _run_port(make_argv(split))
    assert (want is not None) == raises, want
    assert (got is not None) == raises, got
    if raises:
        assert str(got).startswith(
            f"invalid value (nan) encountered in {message}"), str(got)
        port, ref = _site(got, "captionkit_torch"), _site(want, "captionkit")
        assert port and ref[:len(port)] == port, (port, ref)


# -- the guard --------------------------------------------------------------


def _tiny(arch="editnet", V=30):
    mc = ModelConfig(arch=arch, vocab_size=V, emb_dim=8, hidden_dim=8,
                     att_dim=4, feat_dim=6, num_regions=3,
                     compute_dtype="float32")
    model = get_model(mc)
    return mc, model, model.init(0, "cpu")


def test_guard_reads_float_leaves_only_and_names_the_first_nan():
    nan = torch.tensor([0.0, float("nan")])
    clean = {"i": torch.tensor([1, 2]), "b": torch.tensor([True]),
             "f": torch.tensor([float("-inf"), float("inf"), 0.0]),
             "h": torch.tensor([float("-inf")], dtype=torch.bfloat16),
             "n": 3, "s": "text", "none": None}
    with debug_nans():
        check_nans("call", clean)  # -inf and +inf never raise
        check_nans("call", ())
        with pytest.raises(FloatingPointError, match=r"^invalid value \(nan"
                           r"\) encountered in decode_step: out/1/x$"):
            check_nans("decode_step", {"out": (torch.ones(2),
                                               {"x": nan, "y": nan})})
        with pytest.raises(FloatingPointError, match="in c: h$"):
            check_nans("c", {"h": nan.to(torch.bfloat16)})
        with pytest.raises(FloatingPointError, match="in c: 0$"):
            check_nans("c", [nan.to(torch.float16)])
    check_nans("call", {"x": nan})  # flag off


def test_guard_walks_train_states_and_ensembles():
    _, _, params = _tiny()
    cfg = TrainConfig(ema_decay=0.9)
    state = create_train_state(lambda seed: trainable(params), cfg)
    with debug_nans():
        check_nans("step", {"state": state})
        state.opt_state.nu["lang_lstm/wrc"][0, 0] = float("nan")
        with pytest.raises(FloatingPointError,
                           match="in step: state/opt_state/nu/lang_lstm/wrc$"):
            check_nans("step", {"state": state})
        state.opt_state.nu["lang_lstm/wrc"][0, 0] = 0.0
        state.opt_state.ema["fc_b"][1] = float("nan")
        with pytest.raises(FloatingPointError,
                           match="state/opt_state/ema/fc_b$"):
            check_nans("step", {"state": state})
        with torch.no_grad():
            state.params.lang_lstm.base.wh[0, 0] = float("nan")
        with pytest.raises(FloatingPointError,
                           match="state/params/lang_lstm/base/wh$"):
            check_nans("step", {"state": state})
        # The packed-weight caches are derived, not outputs: not walked.
        _, _, other = _tiny()
        other.cache["packed"] = torch.full((2,), float("nan"))
        ens = stack_params([_tiny()[2], other])
        bad = _tiny()[2]
        bad.fc_w[2, 1] = float("nan")
        with pytest.raises(FloatingPointError,
                           match="in stack_params: members/2/fc_w$"):
            stack_params([_tiny()[2], other, bad])
    assert len(ens.members) == 2
    stack_params([_tiny()[2], bad])  # flag off: no check


class _Trap(torch.Tensor):
    """A tensor whose every torch function raises."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        raise AssertionError(f"{func} called on a guarded leaf")


def test_guard_touches_no_tensor_with_the_flag_off():
    trap = torch.zeros(3).as_subclass(_Trap)
    with pytest.raises(AssertionError):
        torch.isnan(trap)
    outputs = {"state": [trap, {"x": trap}], "metrics": (trap,)}
    check_nans("xe_train_step", outputs)
    with debug_nans(), pytest.raises(AssertionError):
        check_nans("xe_train_step", outputs)


class _Calls(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.calls.append(getattr(func, "__name__", str(func)))
        return func(*args, **(kwargs or {}))


def _xe_case():
    mc, model, params = _tiny()
    rng = np.random.default_rng(3)
    B, T = 4, 7
    batch = {"features": torch.from_numpy(rng.standard_normal(
                 (B, 3, 6)).astype(np.float32)),
             "existing": torch.from_numpy(rng.integers(4, 30, (B, 5))),
             "existing_len": torch.tensor([0, 1, 5, 3]),
             "target": torch.from_numpy(rng.integers(4, 30, (B, T))),
             "target_len": torch.tensor([1, 2, T, 4]),
             "valid": torch.tensor([True, True, True, False])}
    cfg = TrainConfig()
    return model, cfg, (lambda: create_train_state(
        lambda seed: trainable(params), cfg)), batch


def test_flag_off_step_makes_the_calls_of_the_unguarded_step(monkeypatch):
    """With the flag off, the XE step makes the same torch calls as the
    step with its guard removed (the CPU view of the card's launch
    count); with it on, the guard's reductions come on top."""
    model, cfg, state, batch = _xe_case()

    def calls(guard):
        if not guard:
            monkeypatch.setattr(t_xe, "check_nans", lambda *a: None)
        step = t_xe.make_xe_train_step(model, cfg)
        with _Calls() as mode:
            step(state(), batch)
        monkeypatch.undo()
        return mode.calls

    unguarded = calls(False)
    assert calls(True) == unguarded
    with debug_nans():
        on = calls(True)
    assert on[:len(unguarded)] == unguarded
    # params, Adam's two moments, the float metrics (tokens are int)
    assert on.count("isnan") == 3 * 26 + 3


def test_xe_calls_raise_on_their_outputs():
    """The k-step pack raises on a NaN only in its last step's features
    (the final state holds it; the CLI's ``train_xe`` cases hold the pack
    against the reference's scan) and not on clean batches; the eval loss
    raises on NaN weights. A raise leaves the state updated in place: the
    tensors and Adam's count advanced, ``step`` not."""
    model, cfg, state, batch = _xe_case()
    k = 3
    stack = {n: torch.stack([t] * k) for n, t in batch.items()}
    clean = dict(stack)
    stack["features"] = stack["features"].clone()
    stack["features"][2, 1, 0, 0] = float("nan")
    fn = t_xe.make_xe_train_multistep(model, cfg)
    evaluate = t_xe.make_eval_loss_step(model)
    st = state()
    with debug_nans():
        st, m = fn(st, clean)
        assert st.step == k and m["loss"].shape == (k,)
        evaluate(st.params, batch)
        with pytest.raises(FloatingPointError,
                           match="in xe_train_multistep: state/params/"):
            fn(st, stack)
        assert st.step == k and st.opt_state.count == 2 * k
        assert torch.isnan(named_tensors(st.params)["fc_w"]).any()
        with pytest.raises(FloatingPointError,
                           match="in eval_loss_step: loss$"):
            evaluate(st.params, batch)


def test_cli_flag_parses_before_the_subcommand_and_stays_on():
    args = cli.build_parser().parse_args(["--debug-nans", "configs"])
    assert args.debug_nans
    assert not cli.build_parser().parse_args(["configs"]).debug_nans
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["configs", "--debug-nans"])
    with debug_nans(False):
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli.main(["--debug-nans", "configs"]) == 0
        assert nan_debugging_enabled()  # on for the rest of the process
    with debug_nans(False):
        enable_nan_debugging()
        with debug_nans(False):
            assert not nan_debugging_enabled()
        assert nan_debugging_enabled()
    with pytest.raises(ZeroDivisionError), debug_nans():
        1 / 0
