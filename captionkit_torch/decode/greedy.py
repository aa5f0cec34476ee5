"""Greedy and sampling rollouts (``captionkit.decode.greedy``).

Each runs ``max_len`` steps of ``model.step`` (the full logits) on the
device of the context, as the reference's scan does: no early exit, so
one batch costs the same whatever its captions. Finished rows keep
emitting ``pad_id`` with log-prob 0. The greedy argmax takes the first
maximal index, as ``jnp.argmax`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from captionkit_torch.models.base import ModelDef

#: the logit given to tokens outside the top-k / nucleus set
TRUNCATED = -1e30


class Rollout(NamedTuple):
    tokens: torch.Tensor  # [B, L] int32 generated tokens (pad after <end>)
    logprobs: torch.Tensor  # [B, L] fp32 log p(token) (0 after finish)
    mask: torch.Tensor  # [B, L] bool: True where the token was emitted
    lengths: torch.Tensor  # [B] int32 emitted tokens (incl. <end>)


def greedy_decode(
    model: ModelDef,
    params: Any,
    ctx: Any,
    *,
    start_id: int,
    end_id: int,
    pad_id: int = 0,
    max_len: int = 22,
) -> Rollout:
    """Batched greedy decode: argmax feedback for ``max_len`` steps."""
    return _rollout(model, params, ctx, start_id=start_id, end_id=end_id,
                    pad_id=pad_id, max_len=max_len, generator=None,
                    temperature=1.0)


def sample_decode(
    model: ModelDef,
    params: Any,
    ctx: Any,
    generator: torch.Generator,
    *,
    start_id: int,
    end_id: int,
    pad_id: int = 0,
    max_len: int = 22,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> Rollout:
    """Batched multinomial sampling. ``generator`` (on the context's
    device) draws the noise; its stream is PyTorch's, so the samples are
    not the reference's ``jax.random`` samples for any seed, only draws
    from the same distribution. ``temperature`` scales the logits first;
    ``top_k`` (> 0) keeps each step's k highest logits (and every logit
    tied with the k-th), ``top_p`` (< 1) the smallest descending-prob
    prefix whose mass reaches p; top_k applies first. The log-probs are
    those of the truncated, renormalized distribution sampled from. A
    draw is the Gumbel-max of the scaled logits, as
    ``jax.random.categorical``'s."""
    return _rollout(model, params, ctx, start_id=start_id, end_id=end_id,
                    pad_id=pad_id, max_len=max_len, generator=generator,
                    temperature=temperature, top_k=top_k, top_p=top_p)


def _truncate_logits(logits: torch.Tensor, top_k: int, top_p: float
                     ) -> torch.Tensor:
    """Logits outside the top-k / nucleus set set to ``TRUNCATED`` (fp32
    in and out). top_k keeps every token tied with the k-th value; top_p
    keeps the minimal prefix of the descending-prob order whose mass
    reaches p (the token that crosses p is kept)."""
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits >= kth, logits, TRUNCATED)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # A token is in the nucleus iff the mass before it is still < p.
        keep_sorted = (cum - probs) < top_p
        thresh = torch.where(keep_sorted, sorted_logits,
                             torch.full_like(sorted_logits, 1e30)
                             ).amin(dim=-1, keepdim=True)
        logits = torch.where(logits >= thresh, logits, TRUNCATED)
    return logits


def _rollout(model: ModelDef, params: Any, ctx: Any, *, start_id: int,
             end_id: int, pad_id: int, max_len: int,
             generator: Optional[torch.Generator], temperature: float,
             top_k: int = 0, top_p: float = 1.0) -> Rollout:
    state = model.init_state(params, ctx, max_len=max_len)
    first = dataclasses.astuple(state)[0]
    batch, dev = first.shape[0], first.device
    tok = torch.full((batch,), start_id, dtype=torch.int32, device=dev)
    done = torch.zeros((batch,), dtype=torch.bool, device=dev)
    tokens, logprobs, emitted_steps = [], [], []
    for _ in range(max_len):
        state, logits = model.step(params, ctx, state, tok)
        if generator is None:
            logp = torch.log_softmax(logits.float(), dim=-1)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            scaled = logits.float() / temperature
            if top_k or top_p < 1.0:
                scaled = _truncate_logits(scaled, top_k, top_p)
            logp = torch.log_softmax(scaled, dim=-1)
            u = torch.rand(scaled.shape, generator=generator, device=dev)
            gumbel = -torch.log(-torch.log(
                u.clamp_min(torch.finfo(torch.float32).tiny)))
            nxt = torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)
        emitted = ~done
        nxt = torch.where(emitted, nxt, pad_id)
        tok_logp = torch.gather(logp, 1, nxt[:, None].long())[:, 0]
        tok_logp = torch.where(emitted, tok_logp, 0.0)
        done = done | (nxt == end_id)
        tokens.append(nxt)
        logprobs.append(tok_logp)
        emitted_steps.append(emitted)
        tok = nxt
    tokens_t = torch.stack(tokens, dim=1)
    mask = torch.stack(emitted_steps, dim=1)
    return Rollout(tokens=tokens_t, logprobs=torch.stack(logprobs, dim=1),
                   mask=mask, lengths=mask.sum(dim=1, dtype=torch.int32))
