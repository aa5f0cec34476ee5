"""Each architecture's module (``ckbench/archs/<arch>.py``) against the
values the harness read before the modules existed: the FLOPs of a
caption at the configurations' widths, the weights a seed gives and the
reference's first-step logits. An unknown architecture raises and names
where it looked; a third module, dropped into a copy of the benchmark,
runs a cell with no file of the copy edited."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ckbench import archs, run
from ckbench.reference.model import Weights

ROOT = Path(__file__).resolve().parents[2]
TINY = dict(vocab_size=60, emb_dim=16, hidden_dim=24, att_dim=8,
            feat_dim=32, num_regions=5)
# read from the harness before the modules: flops.caption_flops at beam 5,
# 22 steps, t = 22 at each configuration file's widths; the sha256 of every
# name and its float32 bytes of inputs.make_weights at TINY, seed 0, on the
# CPU; the reference's first-step logits (row 0's first six, the sum of
# their magnitudes) over _first_step's inputs
PINNED = {
    "editnet": dict(
        config="editnet_beam5_fused", flops=10948247552,
        weights=("91d3feedb670e124931cce2c5c66cd7b"
                 "a1aa970023aad423eca438853303f813"),
        row0=[-0.005769777577370405, 0.003318440169095993,
              -0.026255130767822266, -0.014717276208102703,
              0.009205860085785389, -0.009043657220900059],
        abs_sum=3.519473270906019),
    "dcnet": dict(
        config="dcnet_beam5_fused", flops=5653495808,
        weights=("f3915c844cb8e0243b3312b89ef89f05"
                 "b35d20fe7868668d283e3c751905fbe6"),
        row0=[0.0016969332937151194, -0.00022209665621630847,
              0.016281595453619957, -0.003978190012276173,
              0.011477749794721603, -0.025947848334908485],
        abs_sum=2.663928529684199),
}


def _first_step(arch, w, m):
    g = torch.Generator().manual_seed(0)
    B, T = 4, 7
    feats = torch.randn(B, m["num_regions"], m["feat_dim"], generator=g)
    existing = torch.randint(4, m["vocab_size"] - 2, (B, T), generator=g)
    lengths = torch.tensor([7, 3, 5, 1])
    encode, state0, step = arch.reference
    rw = Weights(w)
    ctx = encode(rw, feats, existing, lengths)
    _, logits = step(rw, ctx, state0(rw, ctx),
                     torch.full((B,), m["vocab_size"] - 2))
    return logits


@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_module_reads_what_the_harness_read(name):
    pin, arch = PINNED[name], archs.get(name)
    conf = json.loads((ROOT / f"ckbench/configs/{pin['config']}.json")
                      .read_text())["model"]
    assert arch.caption_flops(conf, beam=5, steps=22, t=22) == pin["flops"]
    m = dict(TINY, arch=name)
    w = arch.make_weights(m, 0, "cpu")
    digest = hashlib.sha256()
    for n, t in w.items():
        digest.update(n.encode())
        digest.update(t.contiguous().numpy().tobytes())
    assert digest.hexdigest() == pin["weights"]
    logits = _first_step(arch, w, m)
    assert logits[0, :6].tolist() == pytest.approx(pin["row0"], rel=0,
                                                   abs=1e-8)
    assert float(logits.double().abs().sum()) == pytest.approx(
        pin["abs_sum"], rel=1e-6)


def test_an_unknown_architecture_raises_and_names_where_it_looked():
    with pytest.raises(KeyError, match="ckbench/archs/nosuch.py"):
        archs.get("nosuch")
    with pytest.raises(KeyError, match="ckbench/archs/"):
        archs.get("../inputs")
    with pytest.raises(KeyError, match="ckbench/archs/nosuch.py"):
        run.main(["--workload", "dcnet_offline_b1024", "--seed", "1",
                  "--seconds", "0.2", "--trace", "0"], device="cpu",
                 config_set={"model.arch": "nosuch"})


THIRD = '''"""A third architecture: EditNet's program and reference under
another name."""
from ckbench.archs import editnet

make_weights, head, reads_features = (
    editnet.make_weights, editnet.head, editnet.reads_features)
reference, caption_flops = editnet.reference, editnet.caption_flops


def program(model, weights, device):
    return editnet.program({**model, "arch": "editnet"}, weights, device)
'''

RUN_THIRD = """
import json, sys
from types import SimpleNamespace
sys.path.insert(0, %r)
from ckbench import run, spec
from ckbench.record import Record
run.main(["--workload", "third_small", "--seed", "2147483999",
          "--seconds", "0.3", "--trace", "0",
          "--traffic-set", "images=20", "--traffic-set", "batch_size=8",
          "--traffic-set", "sample=8"], device="cpu",
         config_set={"model.vocab_size": 40, "model.emb_dim": 8,
                     "model.hidden_dim": 8, "model.att_dim": 8,
                     "model.feat_dim": 16, "model.num_regions": 3,
                     "limits.score_err": 1.0, "limits.head_err": 1.0})
assert run.__file__.startswith(%r), run.__file__
model = spec.cell(spec.load_benchmark(), "third_small")["config"]["model"]
r = Record(workload="third_small", arch="third", model=model,
           decode={"beam_size": 5, "max_decode_len": 22}, traffic={},
           trace=SimpleNamespace(window_s=1.0), trace_captions=1)
print(json.dumps({"mfu": spec.reader("decode.mfu")(r)}))
"""


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_third_architecture_adds_files_and_edits_none(tmp_path):
    shutil.copytree(ROOT / "ckbench", tmp_path / "ckbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "ckbench")
    (tmp_path / "ckbench/archs/third.py").write_text(THIRD)
    conf = json.loads((ROOT / "ckbench/configs/editnet_beam5_fused.json")
                      .read_text())
    conf["name"], conf["model"]["arch"] = "third_tiny", "third"
    (tmp_path / "ckbench/configs/third_tiny.json").write_text(
        json.dumps(conf))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "third_tiny", "source": "test",
                             "reduced": [], "why": "test",
                             "file": "ckbench/configs/third_tiny.json"})
    bench["workloads"].append({"name": "third_small", "chips": 1,
                               "config": "third_tiny",
                               "traffic": "offline_forced22_b1024",
                               "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run(
        [sys.executable, "-c", RUN_THIRD % (str(tmp_path), str(tmp_path))],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    result, mfu = json.loads(lines[-2]), json.loads(lines[-1])["mfu"]
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"captions_per_s", "setup_s"}
    assert result["attempted"] >= 20 and result["failed"] == 0
    # decode.mfu counts the third module's FLOPs: EditNet's at its widths
    assert mfu == pytest.approx(
        100.0 * PINNED["editnet"]["flops"] / 989e12, rel=1e-12)
    after = _digest(tmp_path / "ckbench")
    assert {k: v for k, v in after.items() if k in before} == before
