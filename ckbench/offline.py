"""Offline traffic: a test split decoded again and again through the port's
``decode_split`` (closed loop, its own two-batch pipeline).

Set-up makes the split and warms it with one whole pass. The window runs
whole passes until one ends past ``--seconds``; ``captions_per_s`` is the
captions of those passes over their time. The decode function handed to
``decode_split`` is the port's ``make_decode_fn``; the benchmark wraps it
in its own span ("ckbench.batch"), keeps the token rows it returns, and in
a traced run profiles a few of the window's batches.
"""

from __future__ import annotations

import time

import numpy as np


def run(h) -> None:
    """``h``: the harness (``run.Harness``) with the program built."""
    from captionkit_torch.data.sources import CaptionDataset
    from captionkit_torch.decode.driver import decode_split, make_decode_fn

    from ckbench import inputs, verify

    t = h.traffic
    cfg, vocab, rec = h.cfg, h.vocab, h.record
    feats, existing, existing_len = inputs.make_split(
        h.model_fields, int(t["images"]), tuple(t["existing_words"]),
        h.seed, cfg.data.max_existing_len, h.device)
    dataset = CaptionDataset(
        features=feats, existing=existing, existing_len=existing_len,
        target=None, target_len=None,
        image_index=np.arange(len(existing), dtype=np.int32), vocab=vocab)
    end_id = vocab.end if t.get("end_token", False) else -1
    decode_fn = make_decode_fn(h.model, cfg.decode, start_id=vocab.start,
                               end_id=end_id, pad_id=vocab.pad,
                               device=h.device)
    B = cfg.decode.batch_size
    state = {"pass": -1, "calls": 0, "timing": False}
    rows = {}  # (pass, batch) -> device tokens [B, L]
    rng = np.random.default_rng(inputs.seed_sequence(h.seed, 7))
    tap_batch = int(rng.integers(0, -(-len(existing) // B)))
    trace_from = int(t.get("trace_after_batches", 2))
    trace_n = int(t.get("trace_batches", 6))

    def timed_fn(params, features, ex, ex_len, batch_idx=0):
        if h.tracer is not None and state["timing"]:
            if state["calls"] == trace_from:
                h.tracer.start()
            elif state["calls"] == trace_from + trace_n:
                h.tracer.stop()
        if h.marks is not None:
            h.marks.batch(B, int(ex_len.clamp(max=ex.shape[1]).sum()))
        h.head_tap.armed = state["timing"] and state["pass"] == 0 \
            and batch_idx == tap_batch
        t0 = time.perf_counter()
        with h.span("ckbench.batch"):
            out = decode_fn(params, features, ex, ex_len, batch_idx)
        h.head_tap.armed = False
        if state["timing"]:
            rec.batch_call_s.append(time.perf_counter() - t0)
            if h.tracer is not None and h.tracer.active:
                rec.trace_batches += 1
                lo = batch_idx * B
                rec.trace_captions += min(B, len(existing) - lo)
            rows[(state["pass"], batch_idx)] = (out, h.beams.last)
        state["calls"] += 1
        return out

    def one_pass():
        state["pass"] += 1
        return decode_split(h.model, h.params, dataset, cfg.decode,
                            decode_fn=timed_fn, device=h.device)[0]

    one_pass()  # warm-up: every shape of the window, the host path too
    h.sync()
    state.update({"pass": -1, "calls": 0, "timing": True})
    passes = []
    h.window_open()
    t0 = time.perf_counter()
    while True:
        passes.append(one_pass())
        if time.perf_counter() - t0 >= h.seconds:
            break
    rec.window_s = time.perf_counter() - t0
    if h.tracer is not None:
        h.tracer.stop()
        rec.trace = h.tracer.summary
    rec.captions = sum(len(p) for p in passes)
    h.window_closed()

    # The sample: (pass, image) pairs of the window, from the seed.
    failed = sum(len(existing) - len(p) for p in passes)
    n_img = len(existing)
    flat = verify.sample_rows(len(passes) * n_img,
                              np.zeros(len(passes) * n_img), h.sample, rng)
    pick_pass, pick_img = flat // n_img, flat % n_img
    tokens = np.stack([
        rows[(int(p), int(i) // B)][0][int(i) % B].cpu().numpy()
        for p, i in zip(pick_pass, pick_img)])
    scores = np.array([
        float(rows[(int(p), int(i) // B)][1][int(i) % B])
        for p, i in zip(pick_pass, pick_img)])
    id2word = {i: w for w, i in h.word2id.items()}
    mismatches = sum(
        passes[int(p)].get(int(i))
        != inputs.detokenize(id2word, row, vocab.end)
        for p, i, row in zip(pick_pass, pick_img, tokens))
    inputs_of = (feats[pick_img] if h.arch.reads_features(h.model_fields)
                 else None, existing[pick_img], existing_len[pick_img])
    rows.clear()
    h.free_program()
    tokens, scores, end_id = h.served(inputs_of, tokens, scores, end_id)
    readings = verify.compare(
        h.weights, h.arch.reference, inputs_of, tokens, scores,
        start_id=vocab.start, end_id=end_id, beam=cfg.decode.beam_size,
        device=h.device)
    readings["mismatches"] = float(mismatches)
    h.finish(attempted=rec.captions, failed=failed, readings=readings)

