"""Holds what the timed path served against the plain reference, once the
window has closed.

A sample of the served captions, drawn from the seed (with the longest
among them), is looked up in the rows that the program's decode returned
in the window. Four numbers are compared, each with its limit from the
configuration file (``limits``):

* ``topk_gap`` (logits): the widest amount by which a served token falls
  short of the reference's K-th best logit, the served tokens
  teacher-forced through the plain float32 model from the sample's own
  inputs (``reference.check.served_path``);
* ``score_err`` (nats a step): the program's own score of each served
  caption (its beam search's summed log-probs, kept as the driver calls
  it: ``instrument.BeamScores``) against the reference's score of the
  same tokens: the program's arithmetic along the whole path (encode,
  cells, head, log-sum-exp), held continuously, not only where it flips
  a choice;
* ``head_err`` (logits): the program's vocab head on a sample of the rows
  it was given in one batch of the window (``instrument.HeadTap``),
  against the float32 head on the same rows: its top-k logits, its
  log-sum-exp and its choice of the top k;
* ``mismatches`` (exact, limit 0): served captions that are not the
  detokenized rows.

A number that has a limit and no reading is not correct (``verdict``).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ckbench.reference.check import beam_search, head_err, served_path
from ckbench.reference.model import Weights, fp8_mm

BLOCK = 128  # reference rows at a time


def served_steps(tokens: np.ndarray, end_id: int) -> np.ndarray:
    """Positions each row's decode served: through its first <end>, or
    all of them (end_id < 0: no end token)."""
    L = tokens.shape[1]
    if end_id < 0:
        return np.full(tokens.shape[0], L)
    hit = tokens == end_id
    return np.where(hit.any(1), hit.argmax(1) + 1, L)


def compare(weights, reference, inputs, tokens, scores, *, start_id,
            end_id, beam, device) -> dict:
    """Readings over the sample through ``reference`` (an architecture's
    (encode, state0, step)): ``inputs`` (features [S, R, F] float32 or
    None, existing [S, T], lengths [S]), the served ``tokens`` [S, L]
    and the program's ``scores`` [S] of them, in blocks of ``BLOCK``
    rows."""
    feats, existing, lengths = inputs
    steps = served_steps(tokens, end_id)
    gaps, errs = [], []
    for lo in range(0, len(tokens), BLOCK):
        sl = slice(lo, lo + BLOCK)
        f = None if feats is None else torch.from_numpy(
            np.ascontiguousarray(feats[sl])).to(device)
        ex = torch.from_numpy(np.asarray(existing[sl], np.int64)).to(device)
        ln = torch.from_numpy(np.asarray(lengths[sl], np.int64)).to(device)
        tk = torch.from_numpy(np.asarray(tokens[sl], np.int64)).to(device)
        st = torch.from_numpy(steps[sl]).to(device)
        gap, logp = served_path(weights, reference, f, ex, ln, tk, st,
                                start_id, beam)
        gaps.append(gap.cpu().numpy())
        errs.append(np.abs(scores[sl] - logp.double().cpu().numpy())
                    / steps[sl])
    return {"topk_gap": float(np.concatenate(gaps).max()),
            "score_err": float(np.concatenate(errs).max())}


def fp8_served(weights, reference, inputs, *, start_id, beam, steps,
               device):
    """The control in the program's place: the beam search of
    ``reference`` with every product in float8 over the sample's inputs,
    (tokens [S, L], scores [S]), in blocks of ``BLOCK`` rows."""
    feats, existing, lengths = inputs
    low = Weights(weights, mm=fp8_mm)
    tokens, scores = [], []
    for lo in range(0, len(existing), BLOCK):
        sl = slice(lo, lo + BLOCK)
        f = None if feats is None else torch.from_numpy(
            np.ascontiguousarray(feats[sl])).to(device)
        ex = torch.from_numpy(np.asarray(existing[sl], np.int64)).to(device)
        ln = torch.from_numpy(np.asarray(lengths[sl], np.int64)).to(device)
        best, seq = beam_search(low, reference, f, ex, ln, start_id, beam,
                                steps)
        tokens.append(seq.cpu().numpy())
        scores.append(best.double().cpu().numpy())
    return np.concatenate(tokens), np.concatenate(scores)


def head_readings(head, taken, k, device) -> dict:
    """``head_err`` over the head calls that ``instrument.HeadTap`` kept,
    against ``head`` (an architecture's ``head(weights)``)."""
    if not taken:
        return {}
    return {"head_err": max(head_err(head, *(t.to(device) for t in call), k)
                            for call in taken)}


def verdict(readings: dict, limits: dict, failed: int, absent=()
            ) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number that has a limit
    read and within it, and nothing failed. A limit with no reading (say,
    no head call was caught) is not correct, but for the names in
    ``absent``, which this run does not produce. Prints each number beside
    its limit on stderr."""
    checks = {}
    ok = failed == 0
    for name in [*limits, *(n for n in readings if n not in limits)]:
        if name not in readings:
            if name in absent:
                continue
            checks[name] = {"value": None, "limit": limits[name]}
            ok = False
            continue
        value, limit = readings[name], limits.get(name, 0)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and bool(value <= limit)
    checks["failed"] = {"value": failed, "limit": 0}
    for name, c in checks.items():
        value = "not read" if c["value"] is None else repr(c["value"])
        print(f"check {name}: {value} (limit {c['limit']!r})",
              file=sys.stderr)
    return ok, checks


def sample_rows(n: int, lengths: np.ndarray, size: int,
                rng: np.random.Generator) -> np.ndarray:
    """``size`` of n rows drawn from the seed, the longest row among
    them."""
    size = min(size, n)
    pick = rng.choice(n, size, replace=False)
    longest = int(np.argmax(lengths))
    if longest not in pick:
        pick[0] = longest
    return np.sort(pick)
