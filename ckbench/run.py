"""The benchmark of ``captionkit_torch`` (the PyTorch and CUDA port).

    python3 ckbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1> [--control] [--traffic-set key=value ...]

Runs one cell of ``BENCHMARK.json`` on this machine's first card: builds
the program from the cell's configuration file through its architecture's
module (``archs/<arch>.py``), makes its inputs and weights from
``--seed``, warms up, measures for ``--seconds`` (``--trace 0``: the
end-to-end metrics) or profiles part of that window (``--trace 1``: the
per-layer metrics), then holds what the window served against the plain
float32 reference (``verify``). The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, ``breakdown`` (traced runs) and ``checks`` (each
number compared, with its limit), which also end standard error.

``--control int8`` runs the program's own lower-precision path (the
configuration's ``control`` settings: the int8 head and feed); ``--control
fp8`` puts the plain reference with every product in float8 in the
program's place for the served captions (``verify.fp8_served``). Their
readings set the upper end of each limit, and they must come out not
correct. ``--traffic-set``
changes a traffic parameter for this run (a rate sweep). Neither is part
of a benchmark run.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: modules that must not be loaded in the process that prints the result
#: (top-level names, compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "captionkit")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def refuse_forbidden() -> None:
    """Exit with code 3, printing no result, where a forbidden module is
    loaded: at the window's close, and again just before the result."""
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {found}", file=sys.stderr)
        raise SystemExit(3)


def _override(obj: dict, pairs) -> dict:
    out = dict(obj)
    for pair in pairs or ():
        key, _, value = pair.partition("=")
        out[key] = json.loads(value)
    return out


class Harness:
    """One run: the program under test, its inputs and what was measured."""

    def __init__(self, args, cell, *, device="cuda", config_set=None):
        import torch

        from ckbench import archs, inputs
        from ckbench.record import Record

        self.args = args
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.device = torch.device(device)
        self.cell = cell
        config = cell["config"]
        self.traffic = _override(cell["traffic"], args.traffic_set)
        self.limits = {**config["limits"], **{
            k[7:]: v for k, v in (config_set or {}).items()
            if k.startswith("limits.")}}
        self.sample = int(self.traffic.get("sample", 256))
        sets = dict(config_set or {})
        if args.control == "int8":
            sets.update(config["control"])
        model = {**config["model"], **{k[6:]: v for k, v in sets.items()
                                      if k.startswith("model.")}}
        decode = {**config["decode"], **{k[7:]: v for k, v in sets.items()
                                        if k.startswith("decode.")},
                  "batch_size": int(self.traffic["batch_size"])}
        data = dict(config.get("data", {}))
        self.arch = archs.get(model["arch"])
        self.model_fields = model
        self.record = Record(workload=cell["workload"]["name"],
                             arch=model["arch"], model=model, decode=decode,
                             traffic=self.traffic)
        self.tracer = self.marks = None
        self._peak = 0
        # The program.
        from captionkit_torch.config import (
            CaptionKitConfig, DataConfig, DecodeConfig)
        from captionkit_torch.data.vocab import Vocab

        self.word2id = inputs.word_map(model["vocab_size"])
        self.vocab = Vocab(self.word2id)
        self.weights = self.arch.make_weights(model, self.seed, self.device)
        model_cfg, self.model, self.params = self.arch.program(
            model, self.weights, self.device)
        self.cfg = CaptionKitConfig(
            name=config["name"], model=model_cfg, data=DataConfig(**data),
            decode=DecodeConfig(**decode))
        from ckbench.instrument import BeamScores, HeadTap

        self.beams = BeamScores()
        self.beams.install()
        self.head_tap = HeadTap(self.sample, inputs.torch_seed(self.seed, 8))
        self.head_tap.install()
        if args.trace:
            from ckbench.instrument import Marks
            from ckbench.trace import Tracer

            self.tracer = Tracer()
            self.marks = Marks()
            self.marks.install()

    def span(self, name: str):
        if self.tracer is None:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def window_open(self) -> None:
        self.sync()
        self.record.setup_s = time.perf_counter() - T_START

    def window_closed(self) -> None:
        import torch

        self.sync()
        self._closed = time.perf_counter()
        if self.device.type == "cuda":
            self._peak = torch.cuda.max_memory_allocated()
        refuse_forbidden()

    def free_program(self) -> None:
        """Drop the program's state (its packed weights and caches) before
        the reference runs; the flat weights stay for the reference."""
        import torch

        if self.marks is not None:
            self.marks.uninstall()
        self.head_tap.uninstall()
        self.beams.uninstall()
        self.params = self.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def served(self, inputs, tokens, scores, end_id):
        """The sample's served (tokens, scores, end id): the program's, or
        under ``--control fp8`` the float8 reference's (no end token)."""
        if self.args.control != "fp8":
            return tokens, scores, end_id
        from ckbench import verify

        self.head_tap.taken.clear()
        tokens, scores = verify.fp8_served(
            self.weights, self.arch.reference, inputs,
            start_id=self.vocab.start, beam=self.cfg.decode.beam_size,
            steps=self.cfg.decode.max_decode_len, device=self.device)
        return tokens, scores, -1

    def finish(self, *, attempted: int, failed: int, readings: dict) -> None:
        from ckbench import spec, verify

        print(f"window {self.record.window_s:.3f} s, set-up "
              f"{self.record.setup_s:.3f} s, check "
              f"{time.perf_counter() - self._closed:.3f} s", file=sys.stderr)
        readings.update(verify.head_readings(
            self.arch.head(self.weights), self.head_tap.taken,
            self.cfg.decode.beam_size, self.device))
        self.head_tap.taken.clear()
        # the float8 reference in the program's place calls no program head
        absent = ("head_err",) if self.args.control == "fp8" else ()
        correct, checks = verify.verdict(readings, self.limits, failed,
                                         absent)
        names = self.cell["per_layer" if self.args.trace else "end_to_end"]
        metrics = spec.read_metrics(names, self.record)
        self.result = {
            "correct": correct, "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics,
            "device": self.device_info()}
        tr = self.record.trace
        if self.args.trace and tr is not None:
            self.result["breakdown"] = {"device_ops": tr.device_ops,
                                        "idle_gaps": tr.idle_gaps}
        self.result["checks"] = checks

    def device_info(self) -> dict:
        import torch

        if self.device.type != "cuda":
            info = {"platform": "cpu", "kind": "cpu", "count": 0,
                    "memory_peak_bytes": 0}
        else:
            info = {"platform": "gpu",
                    "kind": torch.cuda.get_device_name(0), "count": 1,
                    "memory_peak_bytes": int(self._peak),
                    "power_limit": _power_limit()}
        tr = self.record.trace
        if self.args.trace and tr is not None:
            info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        return info


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("int8", "fp8"))
    p.add_argument("--traffic-set", action="append", default=[])
    return p.parse_args(argv)


def main(argv=None, *, device: str = "cuda", config_set=None,
         bench=None) -> dict:
    """Run a cell; returns the result (also printed). Tests only:
    ``device="cpu"`` skips the look for a card, ``config_set`` changes
    configuration fields (and ``limits.<name>``), ``bench`` stands for
    ``BENCHMARK.json``."""
    args = parse(argv)
    from ckbench import spec

    cell = spec.cell(bench or spec.load_benchmark(), args.workload)
    if device == "cuda":
        import torch

        chips = int(cell["workload"]["chips"])
        if not torch.cuda.is_available():
            print("no CUDA device: torch.cuda.is_available() is False",
                  file=sys.stderr)
            raise SystemExit(2)
        if torch.cuda.device_count() < chips:
            print(f"the cell needs {chips} cards, this machine has "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            raise SystemExit(2)
    h = Harness(args, cell, device=device, config_set=config_set)
    kind = h.traffic["kind"]
    if kind != "offline":
        raise ValueError(f"no driver for traffic kind {kind!r}")
    from ckbench import offline

    offline.run(h)
    result = h.result
    refuse_forbidden()  # the readers and the reference ran after the close
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    # Build and kernel caches at fixed paths inside the checkout.
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    main()
