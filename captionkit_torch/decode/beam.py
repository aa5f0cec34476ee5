"""Batched static-shape beam search (``captionkit.decode.beam``).

* All B images x K beams step together as one flattened [B*K] batch, rows
  b*K .. b*K+K-1 per image; the per-step reorder is one row gather of each
  state field with the parents picked by the top-K.
* With the fused head (``ModelDef.step_topk``) the candidates are each
  row's top-K logits minus its log-sum-exp: every global winner is in its
  own row's top-K, so the K*K candidates give the exact top-K of K*V.
* Finished beams are frozen: their only continuation is <pad> at log-prob
  0, so they keep competing with their final score.
* A per-image register holds the top-K hypotheses ever finished, merged
  the step they finish; the result is that register, or the live beams
  where nothing finished.
* The loop is a Python loop; it stops after ``max_len`` steps or once
  every beam of every image is finished (one device-to-host read of the
  done flags per step). Inside a profiler session each read is a
  ``beam.done_read`` span and the rest of the step a ``beam.step`` span,
  in which the state's reorder is a ``beam.reorder`` span
  (``utils/profiling.py``).

Two sequence-history layouts (``impl=``) with identical results:

* ``"register"`` (default): the loop carries the [B, K, L] sequences
  (gathered by parent, the step's token written in place) and the
  register keeps a finished hypothesis's whole sequence.
* ``"backptr"``: the loop records only each step's [B, K] tokens and
  parent slots, in [L, B, K] histories on the device, and the register
  keeps scalars (rank score, finish step, finish slot, length). The
  sequences are rebuilt once, after the loop, on the device, by walking
  the parents back from each selected (step, slot) (``_reconstruct``).

Every place where the reference calls ``lax.top_k`` calls
``topk_lowest_index``: equal scores (NEG_INF plateaus of finished beams,
equal register entries) resolve to the lowest index as they do there.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from captionkit_torch.models.base import ModelDef
from captionkit_torch.nn.masking import NEG_INF
from captionkit_torch.nn.topk import topk_lowest_index
from captionkit_torch.utils.profiling import annotate


class BeamResult(NamedTuple):
    tokens: torch.Tensor  # [B, L] best hypothesis per image (pad-filled)
    scores: torch.Tensor  # [B] its (length-normalized) log-prob score
    lengths: torch.Tensor  # [B] emitted length (incl. <end> if produced)
    # The n-best list: the top-K finished hypotheses for an image where any
    # finished (NEG_INF/pad-filled when fewer than K), else its live beams
    # at exit; score-descending. Row 0 equals (tokens, scores, lengths).
    all_tokens: torch.Tensor  # [B, K, L]
    all_scores: torch.Tensor  # [B, K]
    all_lengths: torch.Tensor  # [B, K]


def _gather_bk(x: torch.Tensor, parent: torch.Tensor) -> torch.Tensor:
    """[B, K, ...] -> the rows of each image's parent slots."""
    index = parent.reshape(*parent.shape, *([1] * (x.dim() - 2)))
    return torch.take_along_dim(x, index, dim=1)


def _reorder_rows(state: Any, rows: torch.Tensor) -> Any:
    """Gather rows [B*K] of every tensor field of a state dataclass."""
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).index_select(0, rows)
        for f in dataclasses.fields(state)})


def _pick(old: torch.Tensor, new: torch.Tensor,
          sel: torch.Tensor) -> torch.Tensor:
    """Entries ``sel`` [B, J] of [old | new] along dim 1 (the register
    merge of [B, K] scalars)."""
    return torch.take_along_dim(torch.cat([old, new], dim=1), sel, dim=1)


def _reconstruct(
    tok_hist: torch.Tensor,  # [L, B, K]
    par_hist: torch.Tensor,  # [L, B, K]
    t_sel: torch.Tensor,  # [B, J] finish step of each selected hypothesis
    slot_sel: torch.Tensor,  # [B, J] the slot it occupied at that step
    active: torch.Tensor,  # [B, J] bool: False rows come out all-pad
    pad_id: int,
    *,
    return_path: bool = False,
):
    """Walk the backpointer chains once, newest step first: position t of a
    selected hypothesis is ``tok_hist[t]`` at its ancestor's slot, found
    by following ``par_hist`` back from (``t_sel``, ``slot_sel``). Returns
    [B, J, L] tokens, pad-filled beyond ``t_sel``.

    With ``return_path=True`` also returns ``slot_at`` [B, J, L], the slot
    the hypothesis occupied after step t (where its step-t token landed),
    and ``src_at`` [B, J, L], the slot it occupied entering step t (the
    parent slot, which indexes what a step records before the reorder).
    Both mean something only for t <= t_sel."""
    L = tok_hist.shape[0]
    cur = slot_sel.long()
    toks, slots, srcs = [], [], []
    for t in range(L - 1, -1, -1):
        on = (t <= t_sel) & active
        tok = torch.gather(tok_hist[t], 1, cur)
        par = torch.gather(par_hist[t], 1, cur)
        toks.append(torch.where(on, tok, pad_id))
        slots.append(cur)
        srcs.append(par)
        cur = torch.where(on, par.long(), cur)

    def unrev(xs):  # newest-first list of [B, J] -> [B, J, L]
        return torch.stack(xs[::-1], dim=2)

    if return_path:
        return unrev(toks), unrev(slots).to(torch.int32), unrev(srcs)
    return unrev(toks)


def beam_search(
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
    impl: str = "register",
) -> BeamResult:
    """Beam search over a whole batch; ``ctx`` tensors are [B, ...].

    length_penalty alpha: rank score = logprob_sum / length**alpha (0 ranks
    by the raw sum). impl: "register" or "backptr", the sequence-history
    layout (module docstring); the results are identical."""
    if impl not in ("backptr", "register"):
        raise ValueError(
            f"beam_search impl must be 'backptr' or 'register', got {impl!r}")
    backptr = impl == "backptr"
    if model.beam_expand is None:
        raise ValueError(f"model {model.name!r} has no beam_expand")
    K = beam_size
    ctx_k = model.beam_expand(ctx, K)
    if model.prepare_topk is not None and model.step_topk is not None:
        ctx_k = model.prepare_topk(params, ctx_k, K)  # once per batch
    model_state = model.init_state(params, ctx_k, max_len=max_len)
    # (not dataclasses.astuple, which deep-copies every field)
    first = getattr(model_state, dataclasses.fields(model_state)[0].name)
    BK, dev = first.shape[0], first.device
    B = BK // K
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)

    def rank(scores, lengths):
        if length_penalty > 0.0:
            return scores / lengths.float().clamp(min=1.0) ** length_penalty
        return scores

    slot0 = torch.arange(K, device=dev)[None, None, :] == 0

    def select_candidates(state, tok, scores, done):
        """One model step + top-K over the K*K (fused head) or K*V
        candidates: (state, top_scores [B, K], parent [B, K], new_tok)."""
        done3 = done[:, :, None]
        if model.step_topk is not None:
            new_state, vals, idx, lse = model.step_topk(
                params, ctx_k, state, tok, K)
            logp = (vals - lse[:, None]).reshape(B, K, K)
            cand_logp = torch.where(
                done3, torch.where(slot0, 0.0, NEG_INF), logp)
            cand_tok = torch.where(done3, pad_id, idx.reshape(B, K, K))
            width = K
        else:
            new_state, logits = model.step(params, ctx_k, state, tok)
            V = logits.shape[-1]
            logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, V)
            pad_row = torch.full((V,), NEG_INF, **f32)
            pad_row[pad_id] = 0.0
            cand_logp = torch.where(done3, pad_row, logp)
            cand_tok = None
            width = V
        total = scores[:, :, None] + cand_logp  # [B, K, width]
        top_scores, flat = topk_lowest_index(total.reshape(B, K * width), K)
        parent = flat // width
        if cand_tok is None:
            new_tok = (flat % width).to(torch.int32)
        else:
            new_tok = torch.take_along_dim(
                cand_tok.reshape(B, K * K), flat, dim=1).to(torch.int32)
        return new_state, top_scores, parent, new_tok

    scores = torch.full((B, K), NEG_INF, **f32)
    scores[:, 0] = 0.0  # one live start hypothesis per image
    done = torch.zeros((B, K), dtype=torch.bool, device=dev)
    lengths = torch.zeros((B, K), **i32)
    tok = torch.full((B * K,), start_id, **i32)
    fin_scores = torch.full((B, K), NEG_INF, **f32)
    fin_len = torch.zeros((B, K), **i32)
    row_base = torch.arange(B, device=dev)[:, None] * K
    if backptr:
        tok_hist = torch.full((max_len, B, K), pad_id, **i32)
        par_hist = torch.zeros((max_len, B, K), **i32)
        fin_t = torch.zeros((B, K), **i32)
        fin_slot = torch.zeros((B, K), **i32)
        slot_ids = torch.arange(K, **i32).expand(B, K)
    else:
        seq = torch.full((B, K, max_len), pad_id, **i32)
        fin_seq = torch.full((B, K, max_len), pad_id, **i32)

    t = 0
    while t < max_len:
        with annotate("beam.done_read"):  # waits for the step before
            if bool(done.all()):
                break
        with annotate("beam.step"):
            new_state, top_scores, parent, new_tok = select_candidates(
                model_state, tok, scores, done)
            if backptr:
                tok_hist[t] = new_tok
                par_hist[t] = parent
            else:
                seq = _gather_bk(seq, parent)
                seq[:, :, t] = new_tok
            was_done = _gather_bk(done, parent)
            lengths = (_gather_bk(lengths, parent)
                       + (~was_done).to(torch.int32))
            done = was_done | (new_tok == end_id)
            with annotate("beam.reorder"):
                model_state = _reorder_rows(
                    new_state, (row_base + parent).reshape(B * K))
            # Register the hypotheses that finished this step; the
            # running register comes first, so equal scores keep the
            # earlier entry.
            newly = done & ~was_done
            cand_rank = torch.where(newly, rank(top_scores, lengths),
                                    NEG_INF)
            fin_scores, sel = topk_lowest_index(
                torch.cat([fin_scores, cand_rank], dim=1), K)
            if backptr:  # scalars only: the sequence is (step, slot)
                fin_t = _pick(fin_t, torch.full((B, K), t, **i32), sel)
                fin_slot = _pick(fin_slot, slot_ids, sel)
            else:
                fin_seq = torch.take_along_dim(
                    torch.cat([fin_seq, seq], dim=1), sel[:, :, None], dim=1)
            fin_len = _pick(fin_len, lengths, sel)
            scores = top_scores
            tok = new_tok.reshape(B * K)
            t += 1

    # Images with a finished hypothesis answer from the register; the rest
    # from their live beams.
    any_fin = fin_scores[:, 0] > NEG_INF / 2
    live_rank = torch.where(any_fin[:, None], NEG_INF, rank(scores, lengths))
    all_scores, sel = topk_lowest_index(
        torch.cat([fin_scores, live_rank], dim=1), K)
    all_lengths = _pick(fin_len, lengths, sel)
    if backptr:
        # Live beams walk back from the last step run, from their slot.
        live_t = torch.full((B, K), max(t - 1, 0), **i32)
        all_tokens = _reconstruct(
            tok_hist, par_hist, _pick(fin_t, live_t, sel),
            _pick(fin_slot, slot_ids, sel), all_scores > NEG_INF / 2,
            pad_id)
    else:
        all_tokens = torch.take_along_dim(
            torch.cat([fin_seq, seq], dim=1), sel[:, :, None], dim=1)
    return BeamResult(
        tokens=all_tokens[:, 0, :],
        scores=all_scores[:, 0],
        lengths=all_lengths[:, 0],
        all_tokens=all_tokens,
        all_scores=all_scores,
        all_lengths=all_lengths,
    )
