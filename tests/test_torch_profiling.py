"""The port's prefetch (``captionkit_torch.data.prefetch``) against
``captionkit.data.prefetch`` on the same numpy batches, the training
loops' prefetched packs against the synchronous copy, and the profiling
helpers (``captionkit_torch.utils.profiling``) beside
``captionkit.utils.profiling``.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from captionkit.data.prefetch import prefetch_to_device as j_prefetch
from captionkit.utils.profiling import ThroughputCounter as JaxCounter

from captionkit_torch.data import SyntheticCaptionSource
from captionkit_torch.data.prefetch import prefetch_to_device
from captionkit_torch.train.loop import _host_dict, _pack_host_batches
from captionkit_torch.train.loop import _prefetch_packs
from captionkit_torch.train.xe import batch_to_device_dict
from captionkit_torch.utils.profiling import (
    ThroughputCounter,
    annotate,
    trace,
)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"features": rng.standard_normal((3, 4, 5)).astype(np.float32),
             "ids": rng.integers(0, 50, (3, 7)).astype(np.int32),
             "valid": rng.random(3) > 0.5,
             "none": None} for _ in range(n)]


@pytest.mark.parametrize("n,size", [(5, 2), (1, 2), (3, 1), (0, 3)])
def test_prefetch_matches_the_reference(n, size):
    batches = _batches(n)
    got = list(prefetch_to_device(iter(batches), size=size, device="cpu"))
    want = list(j_prefetch(iter(batches), size=size))
    assert len(got) == len(want) == n
    for g, w, b in zip(got, want, batches):
        assert g.keys() == w.keys() == b.keys()
        assert g["none"] is None and w["none"] is None
        for k in ("features", "ids", "valid"):
            assert isinstance(g[k], torch.Tensor)
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
            np.testing.assert_array_equal(g[k].numpy(), b[k])
            assert g[k].numpy().dtype == b[k].dtype


def test_prefetch_size_below_one_raises():
    for fn in (lambda b: prefetch_to_device(b, size=0, device="cpu"),
               lambda b: j_prefetch(b, size=0)):
        with pytest.raises(ValueError, match="size"):
            list(fn(iter(_batches(2))))
    with pytest.raises(NotImplementedError):
        list(prefetch_to_device(iter(_batches(1)), device="cpu",
                                mesh=object()))


def test_prefetch_tuples_move_dicts_and_keep_the_rest():
    refs = [[np.arange(3)], [np.arange(2)]]
    items = [(b, r) for b, r in zip(_batches(2), refs)]
    out = list(prefetch_to_device(iter(items), device="cpu"))
    for (b, r), (ob, orefs) in zip(items, out):
        assert orefs is r
        np.testing.assert_array_equal(ob["ids"].numpy(), b["ids"])


def test_loop_packs_equal_the_synchronous_copy():
    """The XE loop's prefetched packs (singles and [k, B, ...] stacks) are
    the tensors ``batch_to_device_dict`` makes, dtypes included."""
    src = SyntheticCaptionSource(num_images=9, captions_per_image=2,
                                 num_regions=3, feat_dim=4, max_len=8,
                                 seed=1)
    host = [_host_dict(b) for b in src.dataset.batches(4)]
    packs = list(_pack_host_batches(iter(host), 2))
    kinds = [k for k, _ in packs]
    assert "multi" in kinds and "single" in kinds
    for (kind, hb), (kind2, got) in zip(packs,
                                        _prefetch_packs(iter(packs), "cpu")):
        assert kind2 == kind
        want = batch_to_device_dict(hb, "cpu")
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k], want[k]), k


def test_throughput_counter_warmup():
    for counter in (ThroughputCounter(warmup=1), JaxCounter(warmup=1)):
        counter.update(100)  # excluded
        assert counter.items == 0
        counter.update(50)
        counter.update(50)
        assert counter.items == 100
        time.sleep(0.01)
        assert counter.items_per_sec > 0


def test_trace_none_is_a_noop(tmp_path):
    with trace(None) as prof:
        x = np.arange(4).sum()
    with annotate("host-phase"):
        x += 1
    assert prof is None and x == 7
    assert os.listdir(tmp_path) == []


def test_trace_writes_a_chrome_trace_naming_the_region(tmp_path):
    d = tmp_path / "prof"
    with trace(str(d)) as prof:
        with annotate("captionkit-region"):
            torch.arange(8).mul(2).sum()
    assert prof is not None
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    events = json.loads((d / files[0]).read_text())["traceEvents"]
    assert any(e.get("name") == "captionkit-region" for e in events)
