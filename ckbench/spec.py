"""Finds a cell's files by the names in ``BENCHMARK.json``.

A configuration is the file its entry names, and its ``model.arch`` the
module ``archs/<arch>.py`` (``archs.get``); a traffic mix is
``traffic/<name>.json``; a metric is ``metrics/<name>.py`` with a
``read(record)`` function that returns a number or None (nothing to read
in this run). Adding any of them adds a file and an entry, and edits no
file that is there.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The workload's entry with its configuration and traffic read in,
    and the metrics it reports with ``--trace 0`` and ``--trace 1``."""
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)

    def applies(metric):
        return workload in metric.get("workloads", [workload])

    return {"workload": w, "config": config, "traffic": traffic,
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)]}


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "ckbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(metrics: list, record) -> dict:
    """{name: {"value", "unit"}} of the metrics whose reader found
    something to read."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
