"""The comparison that decides ``correct``: served tokens against the plain
float32 model.

Every token that a beam search serves was, at its step, among the top K
continuations of its parent hypothesis (the beam keeps the best K of the
K x K candidates, each row's top K). Teacher-forcing the served tokens
through the reference puts the reference in the parent's state at every
step, so each served token's reference logit can be set against the
reference's K-th best logit there: ``topk_gap`` is the widest amount by
which a served token falls short of it (0 where it is inside the top K).
Rounding in the program moves near-ties by a little; a fault anywhere on
the path (the encode, a cell, the head, the beam's bookkeeping, a token
altered) puts tokens far outside.

``beam_search`` is the reference's own beam search of the same width and
length (no end token); with every product in float8 (``model.fp8_mm``)
it is the control that stands in the program's place.
"""

from __future__ import annotations

import torch

from ckbench.reference.model import Weights, expand


@torch.no_grad()
def served_path(weights, reference, features, existing, lengths, tokens,
                steps, start_id, k):
    """Teacher-force the served ``tokens`` [B, L] through ``reference``
    (an architecture's (encode, state0, step)) from ``start_id``; row b
    counts its first ``steps[b]`` positions. Returns (gap [B]: the widest
    K-th-best-logit minus served-logit, floored at 0; logp [B]: the served
    path's summed log-probs over the counted positions)."""
    weights = weights if isinstance(weights, Weights) else Weights(weights)
    encode, state0, step = reference
    ctx = encode(weights, features, existing, lengths)
    state = state0(weights, ctx)
    B, L = tokens.shape
    tok = torch.full((B,), start_id, dtype=torch.long, device=tokens.device)
    gap = torch.zeros(B, device=tokens.device)
    logp = torch.zeros(B, device=tokens.device)
    for t in range(L):
        state, logits = step(weights, ctx, state, tok)
        served = tokens[:, t].long()
        on = t < steps
        kth = logits.topk(k, dim=-1).values[:, -1]
        mine = logits.gather(1, served[:, None])[:, 0]
        gap = torch.where(on, torch.maximum(gap, (kth - mine).clamp(min=0)),
                          gap)
        lp = torch.log_softmax(logits, -1).gather(1, served[:, None])[:, 0]
        logp = logp + torch.where(on, lp, torch.zeros_like(lp))
        tok = served
    return gap, logp


@torch.no_grad()
def beam_search(weights, reference, features, existing, lengths, start_id,
                k, steps):
    """A width-``k`` beam search of ``steps`` steps (no end token) through
    ``reference`` (an architecture's (encode, state0, step)): the best
    path of each image, (summed log-prob [B], tokens [B, steps])."""
    weights = weights if isinstance(weights, Weights) else Weights(weights)
    encode, state0, step = reference
    ctx = expand(encode(weights, features, existing, lengths), k)
    B = existing.shape[0]
    state = state0(weights, ctx)
    dev = existing.device
    scores = torch.full((B, k), -1e9, device=dev)
    scores[:, 0] = 0.0
    seq = torch.zeros((B, k, steps), dtype=torch.long, device=dev)
    tok = torch.full((B * k,), start_id, dtype=torch.long, device=dev)
    base = torch.arange(B, device=dev)[:, None] * k
    for t in range(steps):
        state, logits = step(weights, ctx, state, tok)
        logp = torch.log_softmax(logits, -1)
        V = logp.shape[-1]
        total = (scores[:, :, None] + logp.view(B, k, V)).view(B, k * V)
        scores, flat = total.topk(k, dim=-1)
        parent = flat // V
        rows = (base + parent).view(-1)
        state = tuple(s.index_select(0, rows) for s in state)
        tok = (flat % V).view(-1)
        seq = seq.gather(1, parent[:, :, None].expand(-1, -1, steps)).clone()
        seq[:, :, t] = tok.view(B, k)
    return scores[:, 0], seq[:, 0]


@torch.no_grad()
def head_err(head, h, vals, idx, lse, k):
    """The program's vocab head against the plain float32 ``head`` (w [H, V],
    b [V]: an architecture's ``head(weights)``) on the same hidden rows
    h [n, H] (as the program gave them to its head): the
    widest error of its top-k logits and of its log-sum-exp, and the
    widest amount by which one of its top-k falls short of the
    reference's k-th best."""
    w, b = head
    logits = h.float() @ w + b
    ref_vals = logits.gather(1, idx.long())
    kth = logits.topk(k, dim=-1).values[:, -1]
    return max(float((vals.float() - ref_vals).abs().max()),
               float((lse.float() - torch.logsumexp(logits, -1)).abs().max()),
               float((kth - ref_vals.min(1).values).clamp(min=0).max()))
