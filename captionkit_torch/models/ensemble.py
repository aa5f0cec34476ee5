"""Decode-time checkpoint ensembles: one ``ModelDef`` over M checkpoints of
one configuration (``captionkit.models.ensemble``).

Every decode surface (greedy, sampling, beam with either history layout,
the stacked pipeline, the split driver, serving) runs an ensemble through
the same ``ModelDef`` protocol. The reference runs the members as one
``jax.vmap``; here a loop over the M members runs each member's own step
(and its own cell kernels), one after another.

Layouts: the parameters are ``EnsembleParams`` (the members' parameter
objects, checked alike by ``stack_params``); the context is
``EnsembleContext`` (the members' contexts, plus the combined head once
``prepare_topk`` built it); the state is the member's state dataclass
with every field stacked on axis 1, [B, M, ...] ([B·K, M, ...] in beam
search), so axis 0 stays the batch and beam search's row reorder and
batch discovery work unchanged.

Combination modes (the decode loops renormalize, so both are exact):

* ``"logprob"`` (default): the mean of the member logits, which
  log-softmaxes to the renormalized geometric mean of the members'
  distributions.
* ``"prob"``: logsumexp over the members of their log-softmaxes, minus
  log M: the log of the mean of their probabilities.

In logprob mode the mean of the member logits is one product,
``[h_0 ‖ … ‖ h_{M-1}] @ [[W_0/M]; …] + mean(b)``, so ``prepare_topk``
builds that combined head once a batch (W_m/M in fp32, then rounded to the
compute dtype or quantized, as the member's head is) and ``step_topk``
runs each member's ``step_hidden`` and then the member's configured head
(the ``fused_head_topk`` kernel with either extraction, the int8 kernel,
or their plain versions) once at H' = M·H. Prob mode needs every member's
whole distribution before any top-k, so it has no ``step_topk`` and beam
search takes its full-logits branch. ``step_attn`` (introspection) runs
each member's and reports their mean attention.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch

from captionkit_torch.kernels.head import _div
from captionkit_torch.models.base import ModelDef, head_topk, prepared_head
from captionkit_torch.params import load_params_npz, named_tensors

_MODES = ("logprob", "prob")


@dataclass
class EnsembleParams:
    """The M members' parameter objects (``stack_params``)."""

    members: tuple


@dataclass
class EnsembleContext:
    """The members' contexts, and the combined head of logprob mode once
    ``prepare_topk`` built it (in place of M member heads)."""

    members: tuple
    head_w: Optional[torch.Tensor] = None  # [M·H, Vp] compute dtype, int8
    head_b: Optional[torch.Tensor] = None  # [Vp] fp32, padding -1e30
    head_scale: Optional[torch.Tensor] = None  # [Vp] fp32, int8 only
    head_wt: Optional[torch.Tensor] = None  # [Vp, M·H] int8, int8 only

    def replace(self, **kw) -> "EnsembleContext":
        return dataclasses.replace(self, **kw)


def _shapes(params) -> dict:
    return {n: tuple(t.shape) for n, t in named_tensors(params).items()}


def stack_params(params_list: Sequence[Any]) -> EnsembleParams:
    """The ensemble's parameters from M parameter objects of one
    configuration. Raises if they differ in structure (architecture or
    optional parts) or in any weight's shape."""
    if not params_list:
        raise ValueError("stack_params needs at least one member")
    first = params_list[0]
    ref = _shapes(first)
    for i, p in enumerate(params_list[1:], start=1):
        if type(p) is not type(first) or _shapes(p).keys() != ref.keys():
            raise ValueError(
                "ensemble members have different parameter structures "
                "(mixed architectures or configs?)")
        for name, shape in _shapes(p).items():
            if shape != ref[name]:
                raise ValueError(
                    f"ensemble member {i} leaf shape {shape} != member 0 "
                    f"shape {ref[name]} (different model dims cannot be "
                    "ensembled)")
    return EnsembleParams(members=tuple(params_list))


def _combine(logits_bm: torch.Tensor, mode: str) -> torch.Tensor:
    """[B, M, V] member logits -> [B, V] ensemble scores (fp32),
    log-probabilities up to a per-row constant."""
    if mode == "logprob":
        return logits_bm.float().mean(dim=1)
    logp = torch.log_softmax(logits_bm.float(), dim=-1)
    return torch.logsumexp(logp, dim=1) - math.log(logits_bm.shape[1])


def _member_state(state, m: int):
    """Member m's state: the [B, M, ...] fields' slice m."""
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name)[:, m].contiguous()
        for f in dataclasses.fields(state)})


def _stack_states(states: Sequence[Any]):
    """Member states -> one state of [B, M, ...] fields."""
    return dataclasses.replace(states[0], **{
        f.name: torch.stack([getattr(s, f.name) for s in states], dim=1)
        for f in dataclasses.fields(states[0])})


def _combined_head_wb(member: ModelDef, params: EnsembleParams
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(w_cat [M·H, V] fp32, b_mean [V] fp32): the mean of the member
    logits as one product. Rows are member-major (member m owns rows
    m·H .. (m+1)·H - 1), the layout of the members' hiddens concatenated
    on the feature axis."""
    wbs = [member.head_info.get_wb(p) for p in params.members]
    M = len(wbs)
    w_cat = torch.cat([_div(w.float(), float(M)) for w, _ in wbs], dim=0)
    b_mean = torch.stack([b.float() for _, b in wbs]).mean(dim=0)
    return w_cat, b_mean


def ensemble_model(member: ModelDef, num_members: int, *,
                   mode: str = "logprob") -> ModelDef:
    """``member`` (one configuration's ``ModelDef``) as an M-member
    checkpoint ensemble; its ``params`` are ``stack_params`` of M
    checkpoints of that configuration."""
    if mode not in _MODES:
        raise ValueError(f"ensemble mode must be one of {_MODES}, got "
                         f"{mode!r}")
    if num_members < 1:
        raise ValueError("num_members must be >= 1")
    M = num_members

    def init(seed: int, device="cuda") -> EnsembleParams:
        # M independent random members (tests); real ensembles load
        # trained checkpoints (load_ensemble_params).
        return stack_params([member.init(seed + i, device)
                             for i in range(M)])

    def _check(params: EnsembleParams) -> tuple:
        if len(params.members) != M:
            raise ValueError(f"{M}-member ensemble got "
                             f"{len(params.members)} members")
        return params.members

    def encode(params, features, existing, existing_len):
        return EnsembleContext(members=tuple(
            member.encode(p, features, existing, existing_len)
            for p in _check(params)))

    def init_state(params, ctx):
        return _stack_states([member.init_state(p, c) for p, c in
                              zip(_check(params), ctx.members)])

    def step(params, ctx, state, token, generator=None, train=False):
        states, logits = [], []
        for m, (p, c) in enumerate(zip(_check(params), ctx.members)):
            s, lg = member.step(p, c, _member_state(state, m), token,
                                generator=generator, train=train)
            states.append(s)
            logits.append(lg)
        return _stack_states(states), _combine(torch.stack(logits, dim=1),
                                               mode)

    beam_expand = None
    if member.beam_expand is not None:

        def beam_expand(ctx, k):
            return ctx.replace(members=tuple(
                member.beam_expand(c, k) for c in ctx.members))

    fused_ok = (mode == "logprob" and member.step_topk is not None
                and member.step_hidden is not None
                and member.head_info is not None)
    prepare_topk = step_topk = None
    if fused_ok:
        hi = member.head_info

        def _combined_head(params):
            return prepared_head(*_combined_head_wb(member, params), hi)

        def prepare_topk(params, ctx, k):
            members = ctx.members
            if member.prepare_cells is not None:
                members = tuple(member.prepare_cells(p, c) for p, c in
                                zip(_check(params), members))
            return ctx.replace(members=members, **_combined_head(params))

        def step_topk(params, ctx, state, token, k):
            states, hs = [], []
            for m, (p, c) in enumerate(zip(_check(params), ctx.members)):
                s, h = member.step_hidden(p, c, _member_state(state, m),
                                          token)
                states.append(s)
                hs.append(h)
            if ctx.head_w is None:  # step_topk without prepare_topk
                ctx = ctx.replace(**_combined_head(params))
            # [B, M·H], member-major: the combined head's row order.
            return (_stack_states(states),
                    *head_topk(torch.cat(hs, dim=1), ctx, k, hi))

    step_attn = None
    if member.step_attn is not None:

        def step_attn(params, ctx, state, token):
            states, logits, attns = [], [], []
            for m, (p, c) in enumerate(zip(_check(params), ctx.members)):
                s, lg, at = member.step_attn(p, c, _member_state(state, m),
                                             token)
                states.append(s)
                logits.append(lg)
                attns.append(at)
            # The ensemble reports its members' mean attention.
            attn = {key: torch.stack([a[key] for a in attns]).mean(dim=0)
                    for key in attns[0]}
            return (_stack_states(states),
                    _combine(torch.stack(logits, dim=1), mode), attn)

    return ModelDef(
        name=f"ensemble{M}[{member.name},{mode}]",
        init=init,
        encode=encode,
        init_state=init_state,
        step=step,
        beam_expand=beam_expand,
        step_topk=step_topk,
        prepare_topk=prepare_topk,
        step_attn=step_attn,
    )


def load_ensemble_params(member: ModelDef, paths: Sequence[str],
                         device: "str | torch.device" = "cuda"
                         ) -> EnsembleParams:
    """``stack_params`` over M ``save_params_npz`` files of ``member``'s
    architecture (either package's), on ``device``."""
    return stack_params([load_params_npz(p, device, arch=member.name)
                         for p in paths])
