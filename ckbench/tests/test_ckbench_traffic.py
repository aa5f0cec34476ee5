"""The traffic generator: the same schedule from the same seed (and the
same gaps, reordered, from another), latency counted from the due time,
a held-back server seen as lateness and as missing answers, and the
offline split's last 1,024-row batch padded around its 904 images."""

import json
import os
import threading
import time

import numpy as np
import pytest

from ckbench.traffic.generator import (
    arrivals, make_requests, percentile, run_open_loop)

POISSON = {"rate_per_s": 400, "caption_words": [8, 22], "feature_pool": 16}


def _rng(seed):
    return np.random.default_rng(seed)


def test_the_same_seed_gives_the_same_schedule():
    a = make_requests(POISSON, 2.0, _rng(5), ["x", "y", "z"])
    b = make_requests(POISSON, 2.0, _rng(5), ["x", "y", "z"])
    assert [(r.due, r.words, r.feature) for r in a] == \
        [(r.due, r.words, r.feature) for r in b]


def test_other_seeds_send_the_same_gaps_in_another_order():
    a, b = arrivals(POISSON, 3.0, _rng(1)), arrivals(POISSON, 3.0, _rng(2))
    assert len(a) == len(b) == 1200
    assert not np.array_equal(a, b)
    gaps = [np.sort(np.diff(np.append(x, 3.0))) for x in (a, b)]
    np.testing.assert_allclose(gaps[0], gaps[1], rtol=1e-9, atol=1e-12)
    assert a[0] == 0.0 and a[-1] < 3.0 and np.all(np.diff(a) > 0)


def test_bursts_keep_the_mean_rate():
    t = dict(POISSON, burst_factor=4.0, burst_period_s=0.5, burst_duty=0.25)
    due = arrivals(t, 4.0, _rng(3))
    assert len(due) == 1600 and due[-1] < 4.0
    phase = (due % 0.5) / 0.5
    # a quarter of the time carries 4 / (4 * 0.25 + 0.75) of the rate
    assert np.mean(phase < 0.25) == pytest.approx(4 * 0.25 / 1.75, abs=0.05)


def _echo_server(read_fd, write_fd, *, delay_s=0.0, hold_after=None):
    """Answers each request line with its id after ``delay_s``; with
    ``hold_after`` it stops answering after that many."""
    def serve():
        with os.fdopen(read_fd) as inp, os.fdopen(write_fd, "w") as out:
            out.write(json.dumps({"ready": True}) + "\n")
            out.flush()
            for n, line in enumerate(inp):
                if hold_after is not None and n >= hold_after:
                    continue
                time.sleep(delay_s)
                out.write(json.dumps({"id": json.loads(line)["id"],
                                      "caption": "ok"}) + "\n")
                out.flush()

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    return thread


def _run(due, **server):
    r_in, w_in = os.pipe()
    r_out, w_out = os.pipe()
    thread = _echo_server(r_in, w_out, **server)
    lines = [json.dumps({"id": i}) + "\n" for i in range(len(due))]
    run = run_open_loop(lines, np.asarray(due), w_in, os.fdopen(r_out),
                        wait_s=0.5)
    thread.join(timeout=10)
    assert not thread.is_alive()
    return run


def test_latency_is_counted_from_the_due_time():
    due = np.arange(20) * 0.01
    run = _run(due, delay_s=0.02)
    assert run.ready and len(run.answers) == 20 and run.duplicates == 0
    lat = run.latencies()
    assert np.all(lat >= 0.02)
    # the server takes 20 ms a request and they are due every 10 ms: the
    # queue grows, and the latency from the due time shows it
    assert lat[-1] > lat[0] + 0.1
    assert np.all(run.received[1:] >= run.received[:-1])


def test_a_held_back_server_shows_as_missing_requests():
    due = np.arange(30) * 0.005
    run = _run(due, hold_after=10)
    assert len(run.answers) == 10
    lat = run.latencies()
    assert np.isnan(lat[10:]).all()
    assert percentile(lat, 95.0) == float("inf")
    assert percentile(lat[:10], 95.0) < 1.0


def test_a_late_generator_shows_as_lateness():
    due = np.zeros(5)  # all due at once: the later ones are sent late
    run = _run(due)
    late = run.lateness()
    assert np.all(late >= 0) and np.all(np.isfinite(late))
    fake = np.array([0.0, 0.1])
    r_in, w_in = os.pipe()
    r_out, w_out = os.pipe()
    thread = _echo_server(r_in, w_out)
    lines = [json.dumps({"id": i}) + "\n" for i in range(2)]
    t = iter([0.0, 0.0, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3])

    def clock():  # the generator wakes 0.2 s after the second is due
        return next(t, 0.4)

    run = run_open_loop(lines, fake, w_in, os.fdopen(r_out), wait_s=0.1,
                        clock=clock)
    thread.join(timeout=10)
    assert run.lateness()[1] == pytest.approx(0.25 - 0.1, abs=1e-9)


def test_the_last_batch_of_a_pass_is_padded():
    from captionkit_torch.data.sources import CaptionDataset
    from captionkit_torch.data.vocab import Vocab

    from ckbench import inputs

    n = 5000
    ds = CaptionDataset(
        features=None, existing=np.zeros((n, 22), np.int32),
        existing_len=np.full(n, 8, np.int32), target=None, target_len=None,
        image_index=np.arange(n, dtype=np.int32),
        vocab=Vocab(inputs.word_map(9490)))
    batches = list(ds.batches(1024, feat_shape=(1, 1)))
    assert len(batches) == 5
    last = batches[-1]
    assert last.existing.shape[0] == 1024 and int(last.valid.sum()) == 904
    assert last.image_id[:904].tolist() == list(range(4096, 5000))
