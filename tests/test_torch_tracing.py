"""The decode path's spans and counters (``captionkit_torch.utils.
profiling``), the benchmark's readers of them and ``cli --trace-dir``.

* Off (no profiler session): no ``record_function`` entered, nothing
  stored, the same tokens as under a session.
* On: the counts of every span and counter of a forced-length split and
  their nesting, one ``user_annotation`` in the exported trace per stored
  span; the benchmark's window (a session started inside a decode call
  and stopped inside a later one, or after the passes) gives each reader
  its batches.
* Self time, the refused ``ckbench.`` names, the trace reader putting an
  idle gap down to a port span, each reader with no trace and on a
  hand-filled store, the feed's pinned and pageable bytes, a split whose
  batches are not as many as its size makes.
"""

import json
import os
import time
import types

import pytest
import torch

from captionkit_torch import cli
from captionkit_torch.config import CaptionKitConfig
from captionkit_torch.data import SyntheticCaptionSource
from captionkit_torch.data.featquant import feed_to_device
from captionkit_torch.decode.driver import decode_split, make_decode_fn
from captionkit_torch.models import get_model
from captionkit_torch.utils import profiling
from captionkit_torch.utils.profiling import annotate, count

from ckbench import spec
from ckbench.trace import read_trace

R, F, STEPS = 4, 12, 5
SMALL = {
    "model.emb_dim": 16, "model.hidden_dim": 24, "model.att_dim": 8,
    "model.feat_dim": F, "model.num_regions": R, "model.dropout": 0.0,
    "decode.method": "beam", "decode.beam_size": 3,
    "decode.max_decode_len": STEPS, "decode.batch_size": 4,
    "data.max_existing_len": 12,
}
READERS = ("feed.gather_ms", "feed.host_copy_ms", "search.done_read_ms",
           "search.step_host_ms", "driver.consume_ms", "search.host_reads",
           "feed.pinned_share")
PER_BATCH = ("split.gather", "split.dispatch", "split.consume",
             "split.readback", "split.detokenize", "decode.feed_copy",
             "decode.encode", "decode.search")


@pytest.fixture(autouse=True)
def _empty_store():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def split():
    """A bf16 EditNet beam over 9 images in batches of 4 (3 batches),
    forced to ``STEPS`` steps (no end token)."""
    src = SyntheticCaptionSource(num_images=9, captions_per_image=1,
                                 num_regions=R, feat_dim=F, max_len=12,
                                 seed=0)
    ds = src.eval_view()
    cfg = CaptionKitConfig().override(
        {**SMALL, "model.vocab_size": len(ds.vocab)})
    assert cfg.model.compute_dtype == "bfloat16"
    model = get_model(cfg.model)
    params = model.init(0, device="cpu")
    fn = make_decode_fn(model, cfg.decode, start_id=ds.vocab.start,
                        end_id=-1, pad_id=ds.vocab.pad, device="cpu")
    return model, params, ds, cfg, fn


def _decode(split, decode_fn=None):
    """(hypotheses, the token rows of each decode call in order)."""
    model, params, ds, cfg, fn = split
    inner = decode_fn or fn
    rows = []

    def kept(*args):
        out = inner(*args)
        rows.append(out.clone())
        return out

    hyps, _ = decode_split(model, params, ds, cfg.decode, decode_fn=kept,
                           device="cpu")
    return hyps, rows


def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def test_spans_off_enter_nothing_and_keep_the_tokens(split, monkeypatch):
    with _cpu_profile():
        want_hyps, want_rows = _decode(split)
    profiling.reset()

    def refuse(*a, **k):
        raise AssertionError("record_function entered with no session")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not profiling.enabled()
    hyps, rows = _decode(split)
    assert profiling.summary() == {"spans": {}, "counters": {}}
    assert hyps == want_hyps and len(hyps) == 9
    assert len(rows) == len(want_rows) == 3
    for got, want in zip(rows, want_rows):
        assert torch.equal(got, want)


def test_spans_on_count_every_batch_step_and_read(split, tmp_path):
    with _cpu_profile() as prof:
        _decode(split)
    s = profiling.summary()
    counts = {n: v["count"] for n, v in s["spans"].items()}
    assert counts == {**{n: 3 for n in PER_BATCH},
                      "beam.done_read": STEPS * 3, "beam.step": STEPS * 3,
                      "beam.reorder": STEPS * 3}
    assert s["counters"] == {"feed_bytes_pageable": 3 * 4 * R * F * 4}
    # The nesting: each parent's self time is its total less its children's.
    tot = {n: v["total_ns"] for n, v in s["spans"].items()}
    for parent, children in [
            ("split.dispatch", ("decode.feed_copy", "decode.encode",
                                "decode.search")),
            ("decode.search", ("beam.done_read", "beam.step")),
            ("beam.step", ("beam.reorder",)),
            ("split.consume", ("split.readback", "split.detokenize"))]:
        assert s["spans"][parent]["self_ns"] == \
            tot[parent] - sum(tot[c] for c in children), parent
    for leaf in ("split.gather", "beam.reorder", "split.detokenize"):
        assert s["spans"][leaf]["self_ns"] == tot[leaf] > 0
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    marks = {}
    for ev in events:
        if ev.get("cat") == "user_annotation":
            marks[ev["name"]] = marks.get(ev["name"], 0) + 1
    assert marks == counts


def test_the_benchmarks_window_reads_per_batch():
    """A session started inside the decode call of batch 2 and stopped
    inside that of batch 8, over two passes of 5 batches, as the
    benchmark's traced run does: the outer span of the first call is not
    recorded and its inner spans are, the last call the reverse, so every
    count is 6 and the reads a call are the steps and one read-back."""
    src = SyntheticCaptionSource(num_images=20, captions_per_image=1,
                                 num_regions=R, feat_dim=F, max_len=12,
                                 seed=1)
    ds = src.eval_view()
    cfg = CaptionKitConfig().override(
        {**SMALL, "model.vocab_size": len(ds.vocab)})
    model = get_model(cfg.model)
    params = model.init(1, device="cpu")
    fn = make_decode_fn(model, cfg.decode, start_id=ds.vocab.start,
                        end_id=-1, pad_id=ds.vocab.pad, device="cpu")
    calls = [0]
    prof = _cpu_profile()

    def timed(*args):
        if calls[0] == 2:
            prof.__enter__()
        elif calls[0] == 8:
            prof.__exit__(None, None, None)
        calls[0] += 1
        return fn(*args)

    for _ in range(2):
        decode_split(model, params, ds, cfg.decode, decode_fn=timed,
                     device="cpu")
    counts = {n: v["count"] for n, v in profiling.summary()["spans"].items()}
    assert counts == {**{n: 6 for n in PER_BATCH},
                      "beam.done_read": STEPS * 6, "beam.step": STEPS * 6,
                      "beam.reorder": STEPS * 6}
    r = types.SimpleNamespace(trace=object())
    assert spec.reader("search.host_reads")(r) == STEPS + 1
    assert spec.reader("feed.pinned_share")(r) == 0.0
    for name in READERS[:-1]:
        assert spec.reader(name)(r) > 0, name


def test_a_window_closed_outside_a_decode_call_reads_per_batch():
    """A session started inside the decode call of batch 2 and stopped
    after two passes of 5 batches, outside any decode call: 7 dispatches
    are recorded against 8 decode calls' inner spans and 10 consumes, and
    each reader still reads a call's own spans."""
    src = SyntheticCaptionSource(num_images=20, captions_per_image=1,
                                 num_regions=R, feat_dim=F, max_len=12,
                                 seed=2)
    ds = src.eval_view()
    cfg = CaptionKitConfig().override(
        {**SMALL, "model.vocab_size": len(ds.vocab)})
    model = get_model(cfg.model)
    params = model.init(2, device="cpu")
    fn = make_decode_fn(model, cfg.decode, start_id=ds.vocab.start,
                        end_id=-1, pad_id=ds.vocab.pad, device="cpu")
    calls = [0]
    prof = _cpu_profile()

    def timed(*args):
        if calls[0] == 2:
            prof.__enter__()
        calls[0] += 1
        return fn(*args)

    for _ in range(2):
        decode_split(model, params, ds, cfg.decode, decode_fn=timed,
                     device="cpu")
    prof.__exit__(None, None, None)
    s = profiling.summary()["spans"]
    counts = {n: v["count"] for n, v in s.items()}
    assert (counts["split.dispatch"], counts["decode.search"],
            counts["split.consume"], counts["split.gather"]) == (7, 8, 10, 7)
    r = types.SimpleNamespace(trace=object())
    assert spec.reader("search.host_reads")(r) == STEPS + 1
    assert spec.reader("feed.host_copy_ms")(r) == pytest.approx(
        1e-6 * s["decode.feed_copy"]["total_ns"] / 8)
    assert spec.reader("search.done_read_ms")(r) == pytest.approx(
        1e-6 * s["beam.done_read"]["total_ns"] / 8)
    assert spec.reader("driver.consume_ms")(r) == pytest.approx(
        1e-6 * s["split.consume"]["total_ns"] / 10)


def test_self_time_is_the_duration_less_the_child():
    with _cpu_profile():
        with annotate("parent"):
            time.sleep(0.002)
            with annotate("child"):
                time.sleep(0.003)
            time.sleep(0.001)
    s = profiling.summary()["spans"]
    assert s["parent"]["count"] == s["child"]["count"] == 1
    assert s["parent"]["self_ns"] == \
        s["parent"]["total_ns"] - s["child"]["total_ns"]
    assert s["child"]["self_ns"] == s["child"]["total_ns"] >= 3_000_000
    assert s["parent"]["self_ns"] >= 3_000_000


def test_benchmark_names_are_refused_and_spans_decide_on_entry():
    with _cpu_profile():
        with pytest.raises(ValueError, match="ckbench"):
            annotate("ckbench.batch")
        with pytest.raises(ValueError, match="ckbench"):
            count("ckbench.calls")
    # Off: neither raises nor stores (the gate comes first).
    with annotate("ckbench.batch"):
        count("ckbench.calls")
    assert profiling.summary() == {"spans": {}, "counters": {}}
    prof = _cpu_profile()
    prof.__enter__()
    outer = annotate("split.dispatch")
    outer.__enter__()
    prof.__exit__(None, None, None)
    with annotate("decode.search"):
        count("feed_bytes_pageable", 8)
    outer.__exit__(None, None, None)
    s = profiling.summary()
    assert list(s["spans"]) == ["split.dispatch"] and s["counters"] == {}


def test_the_trace_reader_names_a_gap_after_a_port_span(tmp_path):
    """Two kernels with an idle gap whose middle lies inside a
    ``split.gather`` annotation: the gap is put down to it."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 10,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 110, "dur": 10,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "user_annotation", "name": "split.gather",
         "ts": 20, "dur": 80, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "ts": 5,
         "dur": 3, "tid": 1},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = read_trace(str(path), window_s=1e-4)
    assert got.idle_gaps == [["split.gather", pytest.approx(100e-6)]]
    assert got.spans == {}  # only the benchmark's own spans are kept
    path.write_text(json.dumps({"traceEvents": events[:2]}))
    assert read_trace(str(path), 1e-4).idle_gaps[0][0] == \
        "host Python outside any torch op"


def _fill(name, n, each_ns):
    for _ in range(n):
        profiling._add(name, each_ns)


@pytest.mark.parametrize("name,want", [
    ("feed.gather_ms", 5.0), ("feed.host_copy_ms", 3.0),
    ("search.done_read_ms", 2.0 * 22), ("search.step_host_ms", 1.5 * 22),
    ("driver.consume_ms", 7.0), ("search.host_reads", 23.0),
    ("feed.pinned_share", 25.0)])
def test_each_reader_reads_the_store(name, want):
    read = spec.reader(name)
    traced = types.SimpleNamespace(trace=object())
    assert read(types.SimpleNamespace(trace=None)) is None
    assert read(traced) is None  # an empty store: nothing to read
    _fill("split.gather", 4, 5_000_000)
    _fill("split.dispatch", 3, 90_000_000)  # one fewer, as in a window
    _fill("decode.search", 4, 80_000_000)
    _fill("split.consume", 5, 7_000_000)
    _fill("split.readback", 5, 1_000_000)
    _fill("decode.feed_copy", 4, 3_000_000)
    _fill("beam.done_read", 4 * 22, 2_000_000)
    _fill("beam.step", 4 * 22, 1_500_000)
    profiling._counters.update(feed_bytes_pinned=100,
                               feed_bytes_pageable=300)
    assert read(traced) == pytest.approx(want)
    assert read(types.SimpleNamespace(trace=None)) is None


def test_feed_counts_pinned_and_pageable_bytes_apart():
    class Pinned(torch.Tensor):
        def is_pinned(self, *args):
            return True

    q = torch.zeros((2, R, F), dtype=torch.int8).as_subclass(Pinned)
    scale = torch.ones((2, R))
    feed_to_device((q, scale), "cpu")  # off: nothing counted
    assert profiling.summary()["counters"] == {}
    with _cpu_profile():
        out = feed_to_device((q, scale), "cpu")
        feed_to_device(torch.zeros((3, R, F)), "cpu")
        assert feed_to_device(None, "cpu") is None
    assert torch.equal(out[1], scale)
    assert profiling.summary()["counters"] == {
        "feed_bytes_pinned": 2 * R * F,
        "feed_bytes_pageable": 2 * R * 4 + 3 * R * F * 4}


def test_cli_trace_dir_writes_the_ports_spans(tmp_path, capsys):
    d = tmp_path / "prof"
    sets = {**{k: v for k, v in SMALL.items() if not k.startswith("data.")},
            "decode.batch_size": 2}
    argv = ["--trace-dir", str(d), "decode", "--config", "editnet_beam5",
            "--synthetic", "--images", "3", "--device", "cpu",
            "--no-metrics"]
    for k, v in sets.items():
        argv += ["--set", f"{k}={v}"]
    assert cli.main(argv) == 0
    assert json.loads(capsys.readouterr().out)["captions"] == 3.0
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    names = [e.get("name") for e in json.loads(
        (d / files[0]).read_text())["traceEvents"]
        if e.get("cat") == "user_annotation"]
    assert names.count("split.gather") == 2
    assert "beam.done_read" in names


@pytest.mark.parametrize("change", [-1, 1])
def test_a_split_of_another_length_raises(split, change):
    """``decode_split`` takes ``ceil(size / batch_size)`` batches from the
    split's iterator: one fewer or one more is an error, not lost rows."""
    model, params, ds, cfg, fn = split
    want = list(ds.batches(cfg.decode.batch_size))
    got = want[:change] if change < 0 else want + want[:change]

    class Split:
        size, vocab = ds.size, ds.vocab

        def batches(self, *args, **kwargs):
            return iter(got)

    with pytest.raises(RuntimeError, match="the split gave"):
        decode_split(model, params, Split(), cfg.decode, decode_fn=fn,
                     device="cpu")


def test_device_counters_stay_on_the_device_until_one_read():
    """``count_device`` adds nothing outside a session; inside one it sums
    on the tensor's device, and ``flush_device`` reads every sum once into
    the store (a second flush adds nothing)."""
    profiling.count_device("x.slots", torch.tensor(5))
    profiling.flush_device()
    assert profiling.summary()["counters"] == {}
    with _cpu_profile():
        for n in (3, 4):
            profiling.count_device("x.slots", torch.tensor(n))
        profiling.count_device("x.busiest", torch.tensor(7))
        with pytest.raises(ValueError):
            profiling.count_device("ckbench.x", torch.tensor(1))
    assert profiling.summary()["counters"] == {}  # not read yet
    profiling.flush_device()
    profiling.flush_device()
    assert profiling.summary()["counters"] == {"x.slots": 7, "x.busiest": 7}
