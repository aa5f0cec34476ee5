"""The port's data parallelism (``captionkit_torch.parallel``, the mesh
paths of ``train/xe.py``, ``train/scst.py``, ``decode/driver.py``,
``train/loop.py``, ``train/checkpoint.py``, ``utils/preemption.py``,
``utils/logging.py`` and ``cli train-xe --num-shards``) against the JAX
reference's mesh on the CPU and against the port's own world of one.

The ranks are processes: one fixture starts a world of 4 gloo ranks and
a world of 2 once for the module (``file://`` rendezvous in a temporary
directory, one intra-op thread a rank), each runs every case of its
world and writes its results; the tests compare them. A rank runs this
file as a script, which imports no JAX: the reference runs in the test
process only (``jax.devices()[:4]`` of tests/conftest.py's 8 CPU devices).

Tolerances: fp32 throughout. XE losses and metrics over 3 steps within
rtol 2e-5 of the JAX 4-device mesh, the JAX 1-device run and the port's
world of one (the reference's own bar, tests/test_train.py), weights
within 2e-5; the SCST update's metrics within the same bar of JAX's on
its mesh and weights within 2e-5; decoded hypotheses identical; the
2-rank loop's losses within 1e-4 of the world of one (its epochs average
per-step losses), the ranks' reports and weights equal, a resume after a
preemption bit-equal to the run it interrupted; checkpoint verdicts equal.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from captionkit_torch.config import CaptionKitConfig, ModelConfig, TrainConfig
from captionkit_torch.data import SyntheticCaptionSource
from captionkit_torch.decode.driver import decode_split
from captionkit_torch.models import get_model
from captionkit_torch.models.base import RowShare, dropout_mask
from captionkit_torch.params import load_params_npz, named_tensors
from captionkit_torch.parallel.mesh import (
    Ranks,
    close_ranks,
    init_ranks,
    make_mesh,
    shard_batch_arrays,
)
from captionkit_torch.train.checkpoint import CheckpointManager
from captionkit_torch.train.loop import run_xe_training
from captionkit_torch.train.scst import make_scst_update
from captionkit_torch.train.state import create_train_state, trainable
from captionkit_torch.train.xe import (
    BATCH_KEYS,
    make_eval_loss_step,
    make_xe_train_multistep,
    make_xe_train_step,
)
from captionkit_torch.utils.logging import MetricsLogger

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(vocab_size=60, emb_dim=16, hidden_dim=24, att_dim=8,
             feat_dim=12, num_regions=5)
B, T_IN, T_OUT, L = 8, 7, 9, 6
STEPS = 3
RTOL = 2e-5
TRAIN = dict(learning_rate=1e-2, grad_clip=5.0, seed=3)
SCST_TRAIN = dict(learning_rate=1e-2, grad_clip=0.1, seed=3)
SRC = dict(num_images=16, captions_per_image=2, num_regions=5, feat_dim=12,
           max_len=16, seed=0)
RANK_TIMEOUT_S = 240


# --------------------------------------------------------------------------
# Inputs, made once by the test process and read by every rank
# --------------------------------------------------------------------------

def _batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    V = SMALL["vocab_size"]
    feats = rng.standard_normal((B, SMALL["num_regions"],
                                 SMALL["feat_dim"])).astype(np.float32)
    ex = rng.integers(4, V, (B, T_IN)).astype(np.int32)
    ex_len = rng.integers(1, T_IN + 1, B).astype(np.int32)
    tl = rng.integers(2, T_OUT + 1, B).astype(np.int32)
    tgt = rng.integers(4, V, (B, T_OUT)).astype(np.int32)
    tgt[:, 0] = 1
    for r in range(B):
        tgt[r, tl[r] - 1] = 2
        tgt[r, tl[r]:] = 0
    valid = np.arange(B) < B - 1  # a padding row, as a tail batch has
    return dict(features=feats, existing=ex, existing_len=ex_len,
                target=tgt, target_len=tl, valid=valid)


def _samples(n: int, seed: int) -> tuple:
    """A fixed sample table: tokens, masks, advantages ([B, L] for n = 1,
    else [n, B, L])."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, SMALL["vocab_size"], (n, B, L)).astype(np.int32)
    lens = rng.integers(1, L + 1, (n, B))
    mask = np.arange(L)[None, None, :] < lens[..., None]
    adv = rng.standard_normal((n, B)).astype(np.float32)
    if n == 1:
        return toks[0], mask[0], adv[0]
    return toks, mask, adv


def _model_cfg(dropout: float = 0.0) -> ModelConfig:
    return ModelConfig(**SMALL, arch="editnet", compute_dtype="float32",
                       dropout=dropout)


def _tensors(d: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in d.items()}


def _numpy_params(params) -> dict:
    return {n: t.detach().numpy().copy()
            for n, t in named_tensors(params).items()}


# --------------------------------------------------------------------------
# The cases: each takes a mesh (None: the port's plain world of one) and
# returns numpy results
# --------------------------------------------------------------------------

def _state(params_path, **train):
    params = load_params_npz(params_path, "cpu", arch="editnet")
    return create_train_state(lambda seed: trainable(params),
                              TrainConfig(**train))


def _rows(mesh, tree, stacked=False):
    tree = _tensors(tree) if isinstance(tree, dict) else tree
    return tree if mesh is None else shard_batch_arrays(mesh, tree,
                                                        stacked=stacked)


def case_xe(mesh, inp, dropout=0.0) -> dict:
    """3 steps on one global batch: losses, metrics, weights."""
    model = get_model(_model_cfg(dropout))
    state = _state(inp["params"], **TRAIN)
    step = make_xe_train_step(model, TrainConfig(**TRAIN), mesh)
    batch = _rows(mesh, inp["batch"])
    out = {k: [] for k in ("loss", "top5_acc", "tokens", "grad_norm")}
    for _ in range(STEPS):
        state, m = step(state, batch)
        for k in out:
            out[k].append(float(m[k]))
    out["params"] = _numpy_params(state.params)
    return out


def case_multistep(mesh, inp) -> dict:
    """Two batches as one [2, B, ...] pack."""
    model = get_model(_model_cfg())
    state = _state(inp["params"], **TRAIN)
    pack = {k: np.stack([inp["batch"][k], inp["batch2"][k]])
            for k in BATCH_KEYS}
    fn = make_xe_train_multistep(model, TrainConfig(**TRAIN), mesh)
    state, m = fn(state, _rows(mesh, pack, stacked=True))
    return {"loss": m["loss"].tolist(), "params":
            _numpy_params(state.params)}


def case_eval(mesh, inp) -> dict:
    model = get_model(_model_cfg())
    state = _state(inp["params"], **TRAIN)
    m = make_eval_loss_step(model, mesh)(state.params,
                                         _rows(mesh, inp["batch"]))
    return {k: float(m[k]) for k in ("loss", "top5_acc", "tokens")}


def case_scst(mesh, inp, n: int) -> dict:
    model = get_model(_model_cfg())
    state = _state(inp["params"], **SCST_TRAIN)
    toks, mask, adv = inp[f"samples{n}"]
    stacked = n > 1
    fn = make_scst_update(model, TrainConfig(**SCST_TRAIN), start_id=1,
                          mesh=mesh, num_samples=n)
    args = [_rows(mesh, torch.from_numpy(a), stacked=stacked)
            for a in (toks.astype(np.int64), mask, adv)]
    state, m = fn(state, _rows(mesh, inp["batch"]), *args)
    out = {k: float(v) for k, v in m.items()}
    out["params"] = _numpy_params(state.params)
    return out


def _decode_setup(feed: str):
    src = SyntheticCaptionSource(**SRC)
    cfg = CaptionKitConfig().override({
        **{f"model.{k}": v for k, v in SMALL.items()},
        "model.vocab_size": len(src.vocab), "model.compute_dtype": "float32",
        "decode.beam_size": 3, "decode.max_decode_len": 8,
        "decode.batch_size": 8, "decode.feed_dtype": feed})
    model = get_model(cfg.model)
    return src, cfg, model, model.init(7, "cpu")


def case_decode(mesh, inp, feed: str) -> dict:
    src, cfg, model, params = _decode_setup(feed)
    hyps, stats = decode_split(model, params, src.eval_view(), cfg.decode,
                               device="cpu", mesh=mesh)
    return {"hyps": hyps, "captions": stats["captions"]}


def case_dropout_masks(mesh, inp) -> dict:
    """One mask draw of the step's generator: this rank's rows of it."""
    gen = torch.Generator().manual_seed(11)
    share = gen if mesh is None else RowShare(gen, mesh.rank, mesh.size)
    rows = B if mesh is None else B // mesh.size
    return {"keep": dropout_mask((rows, SMALL["hidden_dim"]), 0.5, share,
                                 "cpu").numpy()}


def case_shards(mesh, inp) -> dict:
    pack = {k: np.stack([inp["batch"][k], inp["batch2"][k]])
            for k in BATCH_KEYS}
    return {"plain": {k: v.numpy() for k, v in
                      shard_batch_arrays(mesh, inp["batch"]).items()},
            "stacked": {k: v.numpy() for k, v in
                        shard_batch_arrays(mesh, pack, stacked=True)
                        .items()}}


def _loop_cfg(tmp: Path, name: str) -> CaptionKitConfig:
    src = SyntheticCaptionSource(**SRC)
    return CaptionKitConfig().override({
        **{f"model.{k}": v for k, v in SMALL.items()},
        "model.vocab_size": len(src.vocab), "model.compute_dtype": "float32",
        "model.dropout": 0.3,
        "data.batch_size": 8, "data.bucket_boundaries": (10, 11, 12, 13),
        "train.epochs": 2,
        "train.steps_per_dispatch": 2, "train.log_every": 1,
        "train.learning_rate": 1e-3,
        "train.checkpoint_dir": str(tmp / name),
        "decode.beam_size": 2, "decode.max_decode_len": 8,
        "decode.batch_size": 8})


class _GuardAfter:
    """A ``PreemptionGuard`` stand-in whose flag rises at poll ``n``."""

    def __init__(self, n):
        self.n = n
        self.polls = 0

    @property
    def requested(self) -> bool:
        self.polls += 1
        return self.n is not None and self.polls >= self.n


def _run_loop(mesh, tmp: Path, name: str, *, val=True, guard=None,
              resume=False, max_steps=None) -> dict:
    cfg = _loop_cfg(tmp, name)
    src = SyntheticCaptionSource(**SRC)
    model = get_model(cfg.model)
    state = create_train_state(lambda seed: model.init(seed, "cpu"),
                               cfg.train)
    ckpt = CheckpointManager(cfg.train.checkpoint_dir, keep=5, mesh=mesh)
    if resume:
        state = ckpt.restore(state)
    logger = MetricsLogger(str(tmp / f"{name}-run"), mesh=mesh)
    state, rep = run_xe_training(
        model, state, cfg, src.dataset, src.eval_view() if val else None,
        mesh=mesh, ckpt=ckpt, metrics_logger=logger, preemption=guard,
        max_steps=max_steps, device="cpu")
    logger.close()
    return {"history": rep.history, "best": rep.best_metric,
            "preempted": rep.preempted, "step": state.step,
            "params": _numpy_params(state.params)}


def case_loop(mesh, inp) -> dict:
    """The 2-rank loop (bucketed batches in k-step packs: every rank must
    cut its rows at the global batch's widths to pack alike): validated
    epochs; a preemption caught on rank 1 only; the resume of that run."""
    tmp = Path(inp["dir"])
    out = {"full": _run_loop(mesh, tmp, "full")}
    rank = 0 if mesh is None else mesh.rank
    out["stopped"] = _run_loop(mesh, tmp, "stopped", val=False,
                               guard=_GuardAfter(3 if rank == 1 else None))
    out["resumed"] = _run_loop(mesh, tmp, "stopped", val=False,
                               resume=True)
    return out


def case_checkpoint(mesh, inp) -> dict:
    """Three saves with metrics 0.5, 0.4, 0.6, rank 1 reaching each one
    late (after rank 0 has written best.json): every rank returns rank
    0's verdict."""
    state = _state(inp["params"], **TRAIN)
    ckpt = CheckpointManager(str(Path(inp["dir"]) / "late"), keep=2,
                             mesh=mesh)
    verdicts = []
    for step, metric in enumerate((0.5, 0.4, 0.6), 1):
        if mesh is not None and mesh.rank == 1:
            time.sleep(0.3)
        verdicts.append(ckpt.save(dataclasses.replace(state, step=step),
                                  metric=metric))
    return {"verdicts": verdicts, "best_step": ckpt.best_step()}


def cli_argv(out: str) -> list:
    return ["train-xe", "--config", "xe_train", "--synthetic", "--images",
            "16", "--max-steps", "3", "--no-val", "--device", "cpu",
            "--export-params", out,
            *(x for k, v in SMALL.items() if k != "vocab_size"
              for x in ("--set", f"model.{k}={v}")),
            "--set", "model.compute_dtype=float32",
            "--set", "data.batch_size=8",
            "--set", f"train.checkpoint_dir={out}.ck"]


FOUR = {"shards": case_shards, "xe": case_xe,
        "xe_dropout": lambda m, i: case_xe(m, i, dropout=0.5),
        "multistep": case_multistep, "eval": case_eval,
        "scst1": lambda m, i: case_scst(m, i, 1),
        "scst2": lambda m, i: case_scst(m, i, 2),
        "decode_float32": lambda m, i: case_decode(m, i, "float32"),
        "decode_int8": lambda m, i: case_decode(m, i, "int8"),
        "dropout_masks": case_dropout_masks}


# --------------------------------------------------------------------------
# A rank: ``python tests/test_torch_parallel.py WORLD RANK DIR``
# --------------------------------------------------------------------------

def _rank_main(world: str, rank: int, root: Path) -> None:
    torch.set_num_threads(1)
    with open(root / "inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    size = 4 if world == "four" else 2
    ranks = init_ranks(f"file://{root / world}.rdv", size, rank, "cpu")
    out = {}
    if world == "four":
        mesh = make_mesh((-1,), ("data",), ranks=ranks)
        for name, fn in FOUR.items():
            out[name] = fn(mesh, inp)
        out["xe_2x2"] = case_xe(make_mesh((2, 2), ("dcn", "ici"),
                                          ranks=ranks), inp)
        close_ranks(ranks)
    else:
        mesh = make_mesh(ranks=ranks)
        out["loop"] = case_loop(mesh, inp)
        out["checkpoint"] = case_checkpoint(mesh, inp)
        close_ranks(ranks)
        from captionkit_torch import cli

        argv = cli_argv(str(root / "cli.npz"))
        out["cli_rc"] = cli.main(argv + ["--num-shards", "2",
                                         "--shard-index", str(rank)])
    with open(root / f"{world}-{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


# --------------------------------------------------------------------------
# The test process
# --------------------------------------------------------------------------

def _flat_jax(jp) -> dict:
    import jax

    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    return {"/".join(str(getattr(k, "name", k)) for k in path):
            np.asarray(leaf) for path, leaf in flat if leaf is not None}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start both worlds, compute the JAX and world-of-one sides while
    they run, then collect every rank's results."""
    import jax

    from captionkit.models import get_model as jax_get_model
    from captionkit.utils.config import ModelConfig as JaxModelConfig

    root = tmp_path_factory.mktemp("ranks")
    jm = jax_get_model(JaxModelConfig(**SMALL, arch="editnet",
                                      compute_dtype="float32", dropout=0.0))
    jp = jm.init(jax.random.PRNGKey(1))
    np.savez(root / "params.npz", **_flat_jax(jp))
    inp = {"params": str(root / "params.npz"), "batch": _batch(0),
           "batch2": _batch(1), "samples1": _samples(1, 2),
           "samples2": _samples(2, 3), "dir": str(root)}
    with open(root / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    env.pop("JAX_PLATFORMS", None)
    procs = {(w, r): subprocess.Popen(
        [sys.executable, __file__, w, str(r), str(root)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for w, n in (("four", 4), ("two", 2)) for r in range(n)}
    try:
        ref = _reference_side(jm, jp, inp)
        one = {name: fn(None, inp) for name, fn in FOUR.items()
               if name not in ("shards",)}
        one["loop"] = case_loop(None, {"dir": str(root / "w1")})
        one["checkpoint"] = case_checkpoint(None, {**inp,
                                                   "dir": str(root / "w1")})
        from captionkit_torch import cli

        one["cli_rc"] = cli.main(cli_argv(str(root / "w1.npz")))
        deadline = time.monotonic() + RANK_TIMEOUT_S
        logs = {}
        for key, p in procs.items():
            logs[key], _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        for key, p in procs.items():
            assert p.returncode == 0, f"rank {key}:\n{logs[key][-4000:]}"
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    got = {}
    for (w, r) in procs:
        with open(root / f"{w}-{r}.pkl", "rb") as f:
            got[(w, r)] = pickle.load(f)
    return {"root": root, "ref": ref, "one": one, "ranks": got,
            "logs": logs}


def _reference_side(jm, jp, inp) -> dict:
    """The JAX reference: 3 XE steps on a 4-device mesh, on one device and
    on a (2, 2) mesh; the eval loss; one SCST update (n = 1, 2) on the
    4-device mesh; the placement of the batch and a [2, B] pack."""
    import jax
    import jax.numpy as jnp

    from captionkit.parallel import make_mesh as j_make_mesh
    from captionkit.parallel import shard_batch_arrays as j_shard
    from captionkit.train.scst import make_scst_update as j_update
    from captionkit.train.state import create_train_state as j_state
    from captionkit.train.xe import make_eval_loss_step as j_eval
    from captionkit.train.xe import make_xe_train_step as j_step
    from captionkit.utils.config import TrainConfig as JTrainConfig

    devs = jax.devices()
    batch = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
    out = {}

    def xe(mesh):
        tcfg = JTrainConfig(**TRAIN, donate_state=False)
        state = j_state(lambda k: jp, tcfg)
        step = j_step(jm, tcfg, mesh)
        b = batch if mesh is None else j_shard(mesh, batch)
        losses = []
        for _ in range(STEPS):
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        return {"loss": losses, "grad_norm": float(m["grad_norm"]),
                "top5_acc": float(m["top5_acc"]),
                "params": _flat_jax(state.params)}

    mesh4 = j_make_mesh((4,), ("data",), devices=devs[:4])
    out["xe4"] = xe(mesh4)
    out["xe1"] = xe(None)
    out["xe2x2"] = xe(j_make_mesh((2, 2), ("dcn", "ici"), devices=devs[:4]))
    m = j_eval(jm)(jp, batch)
    out["eval"] = {k: float(m[k]) for k in ("loss", "top5_acc", "tokens")}
    for n in (1, 2):
        tcfg = JTrainConfig(**SCST_TRAIN, donate_state=False)
        state = j_state(lambda k: jp, tcfg)
        toks, mask, adv = inp[f"samples{n}"]
        fn = j_update(jm, tcfg, start_id=1, mesh=mesh4, num_samples=n)
        state, mm = fn(state, batch, jnp.asarray(toks), jnp.asarray(mask),
                       jnp.asarray(adv))
        out[f"scst{n}"] = {k: float(v) for k, v in mm.items()}
        out[f"scst{n}"]["params"] = _flat_jax(state.params)
    pack = {k: np.stack([inp["batch"][k], inp["batch2"][k]])
            for k in BATCH_KEYS}
    order = list(mesh4.devices.flat)
    for name, tree, stacked in (("plain", inp["batch"], False),
                                ("stacked", pack, True)):
        placed = j_shard(mesh4, tree, stacked=stacked)
        out[f"shards_{name}"] = [
            {k: np.asarray(next(s.data for s in v.addressable_shards
                                if s.device == d))
             for k, v in placed.items()} for d in order]
    return out


def _rank_results(runs, world, case):
    n = 4 if world == "four" else 2
    return [runs["ranks"][(world, r)][case] for r in range(n)]


def _close_params(got: dict, want: dict, atol: float, what: str) -> None:
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=atol, rtol=0,
                                   err_msg=f"{what}: {name}")


def test_make_mesh_shapes_and_errors_match_the_reference():
    import jax

    from captionkit.parallel import make_mesh as j_make_mesh

    eight = Ranks(8, 0, torch.device("cpu"))
    for shape, names in (((-1,), ("data",)), ((2, 4), ("dcn", "ici")),
                         ((2, -1), ("dcn", "ici")), ((8,), ("data",))):
        jm = j_make_mesh(shape, names)
        m = make_mesh(shape, names, ranks=eight)
        assert m.shape == jm.devices.shape and m.axis_names == jm.axis_names
        assert m.size == 8 and m.share == (0, 8) and m.is_main
    for shape, names in (((16,), ("data",)), ((3, -1), ("dcn", "ici"))):
        with pytest.raises(ValueError) as jerr:
            j_make_mesh(shape, names)
        with pytest.raises(ValueError) as err:
            make_mesh(shape, names, ranks=eight)
        assert str(err.value) == str(jerr.value)
    assert len(jax.devices()) == 8
    # The port's own refusals: a shape that leaves ranks out, names that
    # do not fit the shape, a device other than the rank's.
    with pytest.raises(ValueError, match="covers 4 of 8"):
        make_mesh((4,), ("data",), ranks=eight)
    with pytest.raises(ValueError, match="differ in length"):
        make_mesh((2, 4), ("data",), ranks=eight)
    with pytest.raises(ValueError, match="differs"):
        make_mesh(ranks=Ranks(2, 1, torch.device("cpu")), device="cuda")
    one = make_mesh(device="cpu")
    assert (one.shape, one.size, one.rank, one.ranks.group) == \
        ((1,), 1, 0, None)
    with pytest.raises(ValueError, match="W = 3"):
        shard_batch_arrays(make_mesh((3,), ("data",), ranks=Ranks(
            3, 0, torch.device("cpu"))), {"x": np.zeros((8, 2))})


def test_shard_batch_arrays_match_the_reference_shards(runs):
    for r, got in enumerate(_rank_results(runs, "four", "shards")):
        for name in ("plain", "stacked"):
            want = runs["ref"][f"shards_{name}"][r]
            for k in BATCH_KEYS:
                np.testing.assert_array_equal(got[name][k], want[k],
                                              err_msg=f"{name} {k} r{r}")


@pytest.mark.parametrize("case,ref", [("xe", "xe4"), ("xe_2x2", "xe2x2")])
def test_xe_steps_match_the_jax_mesh_and_one_rank(runs, case, ref):
    """3 steps on 4 ranks (a flat and a (2, 2) mesh): the same losses and
    weights as JAX's mesh, JAX's one device and the port's one rank."""
    one = runs["one"]["xe"]
    ranks = _rank_results(runs, "four", case)
    for r, got in enumerate(ranks):
        for want in (runs["ref"][ref], runs["ref"]["xe1"], one):
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)
            np.testing.assert_allclose(got["grad_norm"][-1],
                                       np.ravel(want["grad_norm"])[-1],
                                       rtol=RTOL)
            _close_params(got["params"], want["params"], RTOL,
                          f"{case} rank {r}")
        assert got["tokens"] == one["tokens"]
        np.testing.assert_allclose(got["top5_acc"], one["top5_acc"],
                                   rtol=RTOL)
        # Every rank holds the same replicated weights.
        for name, a in got["params"].items():
            np.testing.assert_array_equal(a, ranks[0]["params"][name])


def test_dropout_keeps_one_ranks_trajectory(runs):
    """At dropout 0.5 every rank draws the global batch's masks from the
    (seed, step) generator and keeps its rows: the 4-rank trajectory is
    the one-rank trajectory."""
    one = runs["one"]["xe_dropout"]
    nodrop = runs["one"]["xe"]["params"]
    assert max(np.abs(a - nodrop[n]).max()
               for n, a in one["params"].items()) > 1e-3
    for got in _rank_results(runs, "four", "xe_dropout"):
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=RTOL)
        _close_params(got["params"], one["params"], RTOL, "dropout")


def test_dropout_masks_differ_between_ranks(runs):
    """The seeding pinned: rank r's mask is rows r of the one-rank mask of
    the same generator, and no two ranks hold the same mask."""
    masks = [g["keep"] for g in _rank_results(runs, "four",
                                              "dropout_masks")]
    np.testing.assert_array_equal(np.concatenate(masks),
                                  runs["one"]["dropout_masks"]["keep"])
    for i in range(4):
        for j in range(i + 1, 4):
            assert not np.array_equal(masks[i], masks[j])


def test_scst_samples_are_seeded_by_rank():
    """The SCST samples of a mesh of more than one rank come from (seed,
    step, rank): no two ranks draw alike, and rank 0 draws as one rank."""
    state = create_train_state(lambda seed: get_model(_model_cfg()).init(
        seed, "cpu"), TrainConfig(**TRAIN))
    draws = [torch.rand(4, generator=state.next_generator("cpu", r))
             for r in range(3)]
    for i in range(3):
        for j in range(i + 1, 3):
            assert not torch.equal(draws[i], draws[j])
    assert torch.equal(torch.rand(4, generator=state.next_generator("cpu")),
                       torch.rand(4, generator=state.next_generator("cpu")))
    # numpy's SeedSequence pads its words with zeros: rank 0 draws what
    # one rank draws.
    assert torch.equal(
        torch.rand(4, generator=state.next_generator("cpu")), draws[0])


def test_multistep_pack_on_the_mesh(runs):
    one = runs["one"]["multistep"]
    for got in _rank_results(runs, "four", "multistep"):
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=RTOL)
        _close_params(got["params"], one["params"], RTOL, "multistep")


def test_eval_loss_step_on_the_mesh(runs):
    for got in _rank_results(runs, "four", "eval"):
        for want in (runs["ref"]["eval"], runs["one"]["eval"]):
            for k in ("loss", "top5_acc", "tokens"):
                np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                           err_msg=k)


@pytest.mark.parametrize("n", [1, 2])
def test_scst_update_matches_the_jax_mesh(runs, n):
    """One update on one fixed sample table: the global loss, advantage
    mean, sample length and gradient norm, and the weights, as JAX's
    update on its 4-device mesh and the port's one rank."""
    for got in _rank_results(runs, "four", f"scst{n}"):
        for want in (runs["ref"][f"scst{n}"], runs["one"][f"scst{n}"]):
            for k in ("scst_loss", "mean_advantage", "sample_len",
                      "grad_norm"):
                np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                           atol=1e-7, err_msg=k)
            _close_params(got["params"], want["params"], RTOL, f"scst{n}")


@pytest.mark.parametrize("feed", ["float32", "int8"])
def test_decode_split_on_the_mesh(runs, feed):
    """Each rank decodes its rows; every rank returns the whole split's
    captions, those of one rank (the int8 feed's (q, scale) split alike)."""
    one = runs["one"][f"decode_{feed}"]
    assert one["captions"] == SRC["num_images"]
    for got in _rank_results(runs, "four", f"decode_{feed}"):
        assert got["hyps"] == one["hyps"]
        assert got["captions"] == one["captions"]


def _untimed(history: list) -> list:
    """An epoch record without its wall times."""
    return [{k: v for k, v in h.items()
             if not k.endswith("_s") and k != "sec_per_step"}
            for h in history]


def test_run_xe_training_on_two_ranks(runs):
    """Two validated epochs: both ranks report the same history, best
    metric and weights, the losses those of one rank; one set of
    checkpoints and one metrics log (not one a rank)."""
    one = runs["one"]["loop"]["full"]
    ranks = [g["full"] for g in _rank_results(runs, "two", "loop")]
    assert _untimed(ranks[0]["history"]) == _untimed(ranks[1]["history"])
    assert ranks[0]["best"] == ranks[1]["best"] > float("-inf")
    for name, a in ranks[0]["params"].items():
        np.testing.assert_array_equal(a, ranks[1]["params"][name])
    assert len(ranks[0]["history"]) == len(one["history"]) == 2
    for got, want in zip(ranks[0]["history"], one["history"]):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["tokens_per_step"],
                                   want["tokens_per_step"], rtol=1e-6)
    root = runs["root"]
    ck = CheckpointManager(str(root / "full"))
    assert ck.all_steps() == CheckpointManager(
        str(root / "w1" / "full")).all_steps() == [4, 8]
    assert ck.best_step() is not None
    lines = (root / "full-run" / "metrics.jsonl").read_text().splitlines()
    want = (root / "w1" / "full-run" / "metrics.jsonl").read_text()
    assert len(lines) == len(want.splitlines())
    assert [json.loads(x)["step"] for x in lines] == \
        [json.loads(x)["step"] for x in want.splitlines()]


def test_preemption_on_one_rank_stops_both(runs):
    """Rank 1 alone catches the signal, at its third poll: both ranks stop
    at the same step, checkpoint it once, and the resumed run ends where
    the uninterrupted run ended, bit for bit."""
    ranks = _rank_results(runs, "two", "loop")
    stopped = [g["stopped"] for g in ranks]
    assert all(s["preempted"] for s in stopped)
    step = stopped[0]["step"]
    assert stopped[1]["step"] == step and 0 < step < 8
    ck = CheckpointManager(str(runs["root"] / "stopped"))
    assert step in ck.all_steps()
    resumed = [g["resumed"] for g in ranks]
    assert resumed[0]["step"] == resumed[1]["step"] == 8
    for name, want in ranks[0]["full"]["params"].items():
        for r in resumed:
            np.testing.assert_array_equal(r["params"][name], want,
                                          err_msg=name)


def test_checkpoint_save_agrees_when_a_rank_comes_late(runs):
    """Only rank 0 reads and writes best.json: a rank that reaches a save
    after rank 0 has written the new best still reports it as the best,
    and the ranks agree with one process."""
    want = runs["one"]["checkpoint"]
    assert want == {"verdicts": [True, False, True], "best_step": 3}
    assert _rank_results(runs, "two", "checkpoint") == [want, want]


def test_cli_train_xe_num_shards_splits_the_global_batch(runs):
    """``cli train-xe --num-shards 2``: two processes on the rendezvous of
    MASTER_ADDR/MASTER_PORT train the global batches of one process (rows
    split, not the reference's strided shard of the split a host), and
    rank 0 writes the export."""
    assert runs["one"]["cli_rc"] == 0
    assert _rank_results(runs, "two", "cli_rc") == [0, 0]
    two = load_params_npz(str(runs["root"] / "cli.npz"), "cpu")
    one = load_params_npz(str(runs["root"] / "w1.npz"), "cpu")
    _close_params(_numpy_params(two), _numpy_params(one), RTOL, "cli")


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), Path(sys.argv[3]))
