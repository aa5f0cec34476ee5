"""Decodes with attention traces (``captionkit.decode.introspect``): the
analysis behind the paper's qualitative figures (which existing-caption
word SCMA copies from at each output step, which region the visual
attention grounds each word in).

Key convention (the models' ``step_attn`` guarantees it): ``vis_alpha``
is always a distribution over REGIONS; ``alpha``/``beta`` are always
distributions over the existing caption's positions and resolve to
source words.

* EditNet: ``vis_alpha`` [B, L, R] over regions, ``beta`` [B, L, T] over
  the existing caption's positions.
* DCNet: ``alpha`` [B, L, T] over the existing caption (plus
  ``vis_alpha`` when the visual flag is on).

Both decodes run ``model.step_attn`` (the plain cells and the full
logits, never a fused head) for all ``max_len`` steps, with no read of
the device inside the loop: the histories stay on the context's device
and the traces come back there. ``attention_report`` turns one image's
trace into a readable per-step record on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from captionkit_torch.decode.beam import (
    BeamResult,
    _gather_bk,
    _pick,
    _reconstruct,
    _reorder_rows,
)
from captionkit_torch.decode.greedy import Rollout
from captionkit_torch.models.base import ModelDef
from captionkit_torch.nn.masking import NEG_INF
from captionkit_torch.nn.topk import topk_lowest_index


class AttentionTrace(NamedTuple):
    rollout: Rollout
    # dict of [B, L, N] fp32 tensors, keys model-specific ("alpha",
    # "beta", "vis_alpha").
    attention: dict[str, torch.Tensor]


class BeamAttentionTrace(NamedTuple):
    # The WINNING hypothesis per image, greedy-trace-shaped so
    # ``attention_report`` takes it unchanged: rollout.tokens [B, L]
    # (== the beam search's tokens), attention [B, L, N] gathered along
    # the winner's backpointer path.
    rollout: Rollout
    attention: dict[str, torch.Tensor]
    # The full n-best result, as ``beam_search`` returns it.
    result: BeamResult


def _first_field(state) -> torch.Tensor:
    return getattr(state, dataclasses.fields(state)[0].name)


def _require_step_attn(model: ModelDef) -> None:
    if model.step_attn is None:
        raise ValueError(f"model {model.name!r} has no step_attn hook")


def greedy_decode_with_attention(
    model: ModelDef,
    params: Any,
    ctx: Any,
    *,
    start_id: int,
    end_id: int,
    pad_id: int = 0,
    max_len: int = 22,
) -> AttentionTrace:
    """Greedy decode with each step's attention distributions. Tokens,
    log-probs and masks are ``greedy_decode``'s (the same argmax, done and
    pad rules over ``step``'s logits)."""
    _require_step_attn(model)
    state = model.init_state(params, ctx)
    first = _first_field(state)
    batch, dev = first.shape[0], first.device
    tok = torch.full((batch,), start_id, dtype=torch.int32, device=dev)
    done = torch.zeros((batch,), dtype=torch.bool, device=dev)
    tokens, logprobs, emitted_steps = [], [], []
    attns: dict[str, list] = {}
    for _ in range(max_len):
        state, logits, attn = model.step_attn(params, ctx, state, tok)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        emitted = ~done
        nxt = torch.where(emitted, nxt, pad_id)
        tok_logp = torch.gather(logp, 1, nxt[:, None].long())[:, 0]
        tok_logp = torch.where(emitted, tok_logp, 0.0)
        done = done | (nxt == end_id)
        tokens.append(nxt)
        logprobs.append(tok_logp)
        emitted_steps.append(emitted)
        for key, v in attn.items():
            attns.setdefault(key, []).append(v.float())
        tok = nxt
    mask = torch.stack(emitted_steps, dim=1)
    roll = Rollout(tokens=torch.stack(tokens, dim=1),
                   logprobs=torch.stack(logprobs, dim=1), mask=mask,
                   lengths=mask.sum(dim=1, dtype=torch.int32))
    return AttentionTrace(
        rollout=roll,
        attention={k: torch.stack(v, dim=1) for k, v in attns.items()})


def beam_decode_with_attention(
    model: ModelDef,
    params: Any,
    ctx: Any,
    *,
    beam_size: int,
    start_id: int,
    end_id: int,
    pad_id: int = 0,
    max_len: int = 22,
    length_penalty: float = 0.0,
) -> BeamAttentionTrace:
    """Beam search with the winning hypothesis's attention trace.

    Token and score semantics are ``beam_search``'s with the full-logits
    candidates (live-slot expansion over [B, K·V], finished beams frozen,
    the finished register, the final n-best selection): its ``backptr``
    layout run for all ``max_len`` steps instead of stopping once every
    beam is done, because the trace stacks each step's attention. The
    steps after all are done change nothing (finished beams continue only
    as <pad> at log-prob 0).

    Each step records every slot's attention ([B, K, N]) beside the [B, K]
    tokens, parents and scores. After the loop the winner's backpointer
    chain is walked once (``beam._reconstruct(return_path=True)``); its
    attention at step t is gathered at the slot it ENTERED step t from
    (``step_attn`` runs before the reorder), its cumulative score at the
    slot its step-t token landed in. Ensembles trace their members' mean
    attention.

    Analysis surface: ``step_attn`` takes no fused head, so run it on
    analysis batches, not the serving path.
    """
    _require_step_attn(model)
    if model.beam_expand is None:
        raise ValueError(f"model {model.name!r} has no beam_expand")
    K = beam_size
    ctx_k = model.beam_expand(ctx, K)
    model_state = model.init_state(params, ctx_k)  # fields [B*K, ...]
    first = _first_field(model_state)
    B, dev = first.shape[0] // K, first.device
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)

    def rank(scores, lengths):
        if length_penalty > 0.0:
            return scores / lengths.float().clamp(min=1.0) ** length_penalty
        return scores

    scores = torch.full((B, K), NEG_INF, **f32)
    scores[:, 0] = 0.0
    done = torch.zeros((B, K), dtype=torch.bool, device=dev)
    lengths = torch.zeros((B, K), **i32)
    tok = torch.full((B * K,), start_id, **i32)
    fin_scores = torch.full((B, K), NEG_INF, **f32)
    fin_t = torch.zeros((B, K), **i32)
    fin_slot = torch.zeros((B, K), **i32)
    fin_len = torch.zeros((B, K), **i32)
    slot_ids = torch.arange(K, **i32).expand(B, K)
    row_base = torch.arange(B, device=dev)[:, None] * K
    tok_hist, par_hist, score_hist = [], [], []
    attn_hist: dict[str, list] = {}
    pad_row = None
    for t in range(max_len):
        new_state, logits, attn = model.step_attn(params, ctx_k, model_state,
                                                  tok)
        V = logits.shape[-1]
        if pad_row is None:
            pad_row = torch.full((V,), NEG_INF, **f32)
            pad_row[pad_id] = 0.0
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, V)
        logp = torch.where(done[:, :, None], pad_row, logp)
        total = scores[:, :, None] + logp  # [B, K, V]
        top_scores, flat = topk_lowest_index(total.reshape(B, K * V), K)
        parent = flat // V
        new_tok = (flat % V).to(torch.int32)
        was_done = _gather_bk(done, parent)
        lengths = _gather_bk(lengths, parent) + (~was_done).to(torch.int32)
        done = was_done | (new_tok == end_id)
        model_state = _reorder_rows(new_state,
                                    (row_base + parent).reshape(B * K))
        newly = done & ~was_done
        cand_rank = torch.where(newly, rank(top_scores, lengths), NEG_INF)
        fin_scores, sel = topk_lowest_index(
            torch.cat([fin_scores, cand_rank], dim=1), K)
        fin_t = _pick(fin_t, torch.full((B, K), t, **i32), sel)
        fin_slot = _pick(fin_slot, slot_ids, sel)
        fin_len = _pick(fin_len, lengths, sel)
        scores = top_scores
        tok = new_tok.reshape(B * K)
        tok_hist.append(new_tok)
        par_hist.append(parent.to(torch.int32))
        score_hist.append(top_scores)
        for key, v in attn.items():
            attn_hist.setdefault(key, []).append(
                v.float().reshape(B, K, v.shape[-1]))

    # The final n-best selection, as beam_search's backptr epilogue.
    L = max_len
    any_fin = fin_scores[:, 0] > NEG_INF / 2
    live_rank = torch.where(any_fin[:, None], NEG_INF, rank(scores, lengths))
    all_scores, sel = topk_lowest_index(
        torch.cat([fin_scores, live_rank], dim=1), K)
    all_lengths = _pick(fin_len, lengths, sel)
    live_t = torch.full((B, K), max(L - 1, 0), **i32)
    all_tokens, slot_at, src_at = _reconstruct(
        torch.stack(tok_hist), torch.stack(par_hist),
        _pick(fin_t, live_t, sel), _pick(fin_slot, slot_ids, sel),
        all_scores > NEG_INF / 2, pad_id, return_path=True)  # [B, K, L]
    result = BeamResult(
        tokens=all_tokens[:, 0, :],
        scores=all_scores[:, 0],
        lengths=all_lengths[:, 0],
        all_tokens=all_tokens,
        all_scores=all_scores,
        all_lengths=all_lengths,
    )

    # Winner-path gathers: attention by the slot entering step t (src_at),
    # the cumulative score by the slot after it (slot_at).
    src0 = src_at[:, 0, :].long()  # [B, L]
    slot0 = slot_at[:, 0, :].long()
    mask = torch.arange(L, device=dev)[None, :] < result.lengths[:, None]

    def winner_attn(hist):  # L x [B, K, N] -> [B, L, N]
        h = torch.stack(hist, dim=1)  # [B, L, K, N]
        idx = src0[:, :, None, None].expand(B, L, 1, h.shape[-1])
        out = torch.gather(h, 2, idx)[:, :, 0, :]
        return torch.where(mask[:, :, None], out, 0.0)

    attention = {k: winner_attn(v) for k, v in attn_hist.items()}
    # Per-step token log-probs: successive differences of the winner's
    # cumulative score along its slot path (frozen <pad> steps diff to 0,
    # and are masked anyway).
    cum = torch.gather(torch.stack(score_hist, dim=1), 2,
                       slot0[:, :, None])[:, :, 0]  # [B, L]
    prev = torch.cat([torch.zeros((B, 1), **f32), cum[:, :-1]], dim=1)
    roll = Rollout(tokens=result.tokens,
                   logprobs=torch.where(mask, cum - prev, 0.0),
                   mask=mask, lengths=result.lengths)
    return BeamAttentionTrace(rollout=roll, attention=attention,
                              result=result)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def attention_report(
    trace: AttentionTrace,
    image: int,
    vocab,
    existing_tokens,  # [T] the existing caption's ids
) -> list[dict]:
    """One image's per-step record: emitted word + the argmax source of
    each attention distribution (SCMA beta / text alpha resolve to the
    existing caption's words; visual alpha to a region index)."""
    toks = _host(trace.rollout.tokens[image])
    mask = _host(trace.rollout.mask[image])
    # Positional (no special-token stripping): beta/alpha index the
    # encoder's padded positions, so the word list must align 1:1.
    existing_words = vocab.decode(_host(existing_tokens),
                                  strip_special=False)
    attention = {k: _host(v[image]) for k, v in trace.attention.items()}
    out = []
    for t in range(len(toks)):
        if not mask[t]:
            break
        rec: dict = {
            "step": t,
            "word": vocab.id2word.get(int(toks[t]), "<unk>"),
        }
        for key, arr in attention.items():
            dist = arr[t]
            j = int(dist.argmax())
            rec[key + "_argmax"] = j
            rec[key + "_weight"] = float(dist[j])
            # Resolve to a source word only for caption-position
            # distributions ("alpha"/"beta" by the key convention above);
            # "vis_alpha" indexes regions, never words — even when the
            # region count happens to equal the padded caption length.
            if key != "vis_alpha" and j < len(existing_words):
                rec[key + "_word"] = existing_words[j]
        out.append(rec)
    return out
