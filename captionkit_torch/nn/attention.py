"""Additive (Bahdanau) attention and SCMA selection
(``captionkit.nn.attention``).

score_i = v . tanh(keys_i + W_q q + b), weights = softmax(score) over the
unmasked positions, context = sum_i weights_i values_i. SCMA scores the
caption encoder's hidden states and reads its cell states: "soft" returns
the attention read, "hard" the cell state at the argmax (straight-through
in the reference; the forward value is the gathered state).

Grouped queries: when the query batch is G times the key batch (beam
search flattens B images x K beams, rows b*K .. b*K+K-1 per image), keys
and values stay per image and are not repeated.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from captionkit_torch.nn.cells import mm
from captionkit_torch.nn.masking import mask_logits


@dataclass
class AdditiveAttentionParams:
    w_enc: torch.Tensor  # [enc_dim, A] key projection
    w_q: torch.Tensor  # [q_dim, A] query projection
    v: torch.Tensor  # [A] score vector
    b: torch.Tensor  # [A] bias inside tanh
    # The fused attention kernel's padded weights per compute dtype
    # (``kernels/attention.py``); clear after changing the weights in place.
    cache: dict = field(default_factory=dict, repr=False, compare=False)


def project_keys(params: AdditiveAttentionParams, enc: torch.Tensor, *,
                 compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """W_e e_i for every position, once per sequence: [B, N, A] fp32."""
    return mm(enc, params.w_enc, compute_dtype)


def additive_attention(
    params: AdditiveAttentionParams,
    keys: torch.Tensor,  # [B, N, A] pre-projected
    values: torch.Tensor,  # [B, N, V]
    query: torch.Tensor,  # [B*G, q_dim]
    mask: Optional[torch.Tensor] = None,  # [B, N] bool, True = attendable
    *,
    compute_dtype: torch.dtype = torch.float32,
    w_q: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (context [B*G, V] fp32, weights [B*G, N]). ``w_q`` takes the
    query projection already in the compute dtype."""
    dt = compute_dtype
    kB, qB = keys.shape[0], query.shape[0]
    if qB % kB:
        raise ValueError(
            f"query batch {qB} is not a multiple of key batch {kB}")
    G = qB // kB
    q = mm(query, params.w_q if w_q is None else w_q, dt)  # [qB, A]
    qg = q.reshape(kB, G, -1)
    e = torch.tanh(keys.float()[:, None, :, :] + qg[:, :, None, :]
                   + params.b)  # [B, G, N, A]
    scores = e @ params.v  # [B, G, N]
    if mask is not None:
        scores = mask_logits(scores, mask[:, None, :])
    weights = torch.softmax(scores, dim=-1)
    # weights cast to the values' dtype, product accumulated in fp32
    w_cast = weights.to(values.dtype).float()
    ctx = torch.bmm(w_cast, values.float())  # [B, G, V]
    return ctx.reshape(qB, -1), weights.reshape(qB, scores.shape[-1])


def scma_select(
    params: AdditiveAttentionParams,
    keys: torch.Tensor,  # [B, T, A] pre-projected encoder hidden states
    memories: torch.Tensor,  # [B, T, H] encoder cell states (copy pool)
    query: torch.Tensor,  # [B*G, q_dim]
    mask: Optional[torch.Tensor] = None,  # [B, T]
    *,
    mode: str = "soft",
    compute_dtype: torch.dtype = torch.float32,
    w_q: Optional[torch.Tensor] = None,
    attention_fn: Optional[Callable] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Selective Copy Memory Attention. Returns (c_star [B*G, H] fp32,
    weights [B*G, T]). ``attention_fn`` replaces ``additive_attention``
    (``nn.dispatch.get_attention_fn``)."""
    attn = attention_fn or additive_attention
    ctx_soft, weights = attn(
        params, keys, memories, query, mask, compute_dtype=compute_dtype,
        w_q=w_q)
    if mode == "soft":
        return ctx_soft, weights
    if mode != "hard":
        raise ValueError(f"unknown SCMA mode {mode!r}")
    # argmax returns the first maximal index, as jnp.argmax does.
    idx = torch.argmax(weights, dim=-1)  # [qB]
    kB, qB = memories.shape[0], idx.shape[0]
    G = qB // kB
    hard = torch.gather(
        memories, 1,
        idx.reshape(kB, G, 1).expand(kB, G, memories.shape[-1]),
    ).reshape(qB, -1).float()
    # The reference's straight-through form, evaluated in the same order:
    # the forward value is the gathered state, the gradient the soft read's.
    return ctx_soft + (hard - ctx_soft).detach(), weights
