"""The harness: what a run imports, how it finds a cell's files, and the
cells on a card.

* Importing the harness, every configuration, traffic and metric loads no
  module whose top-level name is exactly ``jax`` or ``captionkit``
  (``captionkit_torch`` is the program under test); the reference loads
  nothing of ``captionkit_torch`` either.
* A run in which something loads a module named ``jax`` after the
  window has closed (here a metric reader) prints no result and exits
  with another code than 0.
* A configuration, a traffic mix and a metric dropped into a copy of the
  benchmark are found by their names, with no file of it edited.
* On a card (skipped elsewhere, decided in the ``card`` fixture): each
  cell runs and is correct, and each control is not.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _loaded(code: str, cwd=ROOT) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    code = """
import json
from pathlib import Path
import ckbench.run, ckbench.spec as spec, ckbench.offline
import ckbench.trace, ckbench.verify, ckbench.instrument, ckbench.inputs
import ckbench.traffic.generator
from ckbench import archs
bench = spec.load_benchmark()
for w in bench["workloads"]:
    archs.get(spec.cell(bench, w["name"])["config"]["model"]["arch"])
for m in bench["end_to_end"] + bench["per_layer"]:
    spec.reader(m["name"])
"""
    top = _loaded(code)
    assert not top & {"jax", "jaxlib", "flax", "captionkit"}, top
    assert "captionkit_torch" not in top  # the harness loads it in a run


def test_the_reference_loads_nothing_of_the_program():
    top = _loaded("import ckbench.reference.check, ckbench.reference.model\n"
                  "from ckbench import archs\n"
                  "for a in ('editnet', 'dcnet'):\n"
                  "    archs.get(a).reference")
    assert not top & {"jax", "jaxlib", "flax", "captionkit",
                      "captionkit_torch"}, top


def test_a_tiny_run_loads_no_jax():
    code = """
from ckbench import run
run.main(["--workload", "editnet_offline_b1024", "--seed", "5",
          "--seconds", "0.5", "--trace", "0",
          "--traffic-set", "images=20", "--traffic-set", "batch_size=8",
          "--traffic-set", "sample=8"], device="cpu",
         config_set={"model.vocab_size": 40, "model.emb_dim": 8,
                     "model.hidden_dim": 8, "model.att_dim": 8,
                     "model.feat_dim": 16, "model.num_regions": 3})
"""
    top = _loaded(code)
    assert "captionkit_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "captionkit"}, top


TINY_RUN = """
import sys
sys.path.insert(0, %r)
from ckbench import run
run.main(["--workload", "editnet_offline_b1024", "--seed", "5",
          "--seconds", "0.5", "--trace", "0",
          "--traffic-set", "images=20", "--traffic-set", "batch_size=8",
          "--traffic-set", "sample=8"], device="cpu",
         config_set={"model.vocab_size": 40, "model.emb_dim": 8,
                     "model.hidden_dim": 8, "model.att_dim": 8,
                     "model.feat_dim": 16, "model.num_regions": 3,
                     "limits.score_err": 1.0, "limits.head_err": 1.0})
"""


def test_jax_loaded_after_the_window_prints_no_result(tmp_path):
    shutil.copytree(ROOT / "ckbench", tmp_path / "ckbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    (tmp_path / "ckbench/metrics/extra.loads_jax.py").write_text(
        "def read(r):\n    import jax  # noqa: F401\n    return 1.0\n")
    bench = json.loads(json.dumps(BENCH))
    bench["end_to_end"].append({"name": "extra.loads_jax", "unit": "s",
                                "better": "lower", "bound": 0.25,
                                "source": "host_clock"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run(
        [sys.executable, "-c", TINY_RUN % str(tmp_path)], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
        env={**os.environ,
             "PYTHONPATH": os.pathsep.join([str(tmp_path / "stub"),
                                            str(ROOT)])})
    assert out.returncode != 0, out.stdout[-2000:]
    assert out.stdout.strip() == ""
    assert "loaded in this process: ['jax']" in out.stderr, out.stderr[-2000:]


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "ckbench", tmp_path / "ckbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "ckbench")
    bench = json.loads(json.dumps(BENCH))
    conf = json.loads((ROOT / "ckbench/configs/dcnet_beam5_fused.json")
                      .read_text())
    conf["name"] = "dcnet_beam5_wide"
    (tmp_path / "ckbench/configs/dcnet_beam5_wide.json").write_text(
        json.dumps(conf))
    traffic = json.loads((ROOT / "ckbench/traffic/offline_forced22_b1024"
                          ".json").read_text())
    traffic["images"] = 12
    (tmp_path / "ckbench/traffic/offline_small.json").write_text(
        json.dumps(traffic))
    (tmp_path / "ckbench/metrics/extra.captions.py").write_text(
        "def read(r):\n    return r.captions or None\n")
    bench["configs"].append({"name": "dcnet_beam5_wide",
                             "source": "test", "reduced": [], "why": "test",
                             "file": "ckbench/configs/dcnet_beam5_wide.json"})
    bench["workloads"].append({"name": "dcnet_small", "chips": 1,
                               "config": "dcnet_beam5_wide",
                               "traffic": "offline_small", "why": "test"})
    bench["end_to_end"].append({"name": "extra.captions", "unit": "captions",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["dcnet_small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = """
import json, sys
sys.path.insert(0, %r)
from ckbench import run
res = run.main(["--workload", "dcnet_small", "--seed", "9",
                "--seconds", "0.2", "--trace", "0",
                "--traffic-set", "batch_size=4", "--traffic-set", "sample=4"],
               device="cpu",
               config_set={"model.vocab_size": 40, "model.emb_dim": 8,
                           "model.hidden_dim": 8, "model.att_dim": 8,
                           "model.feat_dim": 16, "model.num_regions": 3,
                           "limits.score_err": 1.0, "limits.head_err": 1.0})
assert run.__file__.startswith(%r), run.__file__
""" % (str(tmp_path), str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result
    assert result["metrics"]["extra.captions"]["value"] >= 12
    # captions_per_s lists no cells, so the new cell reports it too
    assert set(result["metrics"]) == {"extra.captions", "captions_per_s",
                                      "setup_s"}
    after = _digest(tmp_path / "ckbench")
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_checkout_without_the_program_prints_no_result(tmp_path):
    shutil.copytree(ROOT / "ckbench", tmp_path / "ckbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "ckbench/run.py", "--workload",
         "editnet_offline_b1024", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def _cell(workload, *extra):
    out = subprocess.run(
        [sys.executable, "ckbench/run.py", "--workload", workload,
         "--seed", "2147483701", "--seconds", "3", "--trace", "0", *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_runs_correct_on_the_card(card, workload):
    result = _cell(workload)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert "setup_s" in result["metrics"]


@pytest.mark.parametrize("control", ["int8", "fp8"])
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_control_is_not_correct_on_the_card(card, workload, control):
    result = _cell(workload, "--control", control)
    assert not result["correct"], result["checks"]
