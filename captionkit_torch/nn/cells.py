"""Recurrent cells: standard LSTM and the Copy-LSTM (``captionkit.nn.cells``).

Gates are ordered (i, f, g, o) with one summed bias; c' = f*c + i*tanh(g),
h' = o*tanh(c'). The Copy-LSTM blends the SCMA-selected memory c* into the
cell through the copy gate r = sigmoid([x|h|c*] W_r + b_r):
c' = r*c* + (1-r)*c_gen.

Weights keep the reference layout, [in, out]. Every product goes through
``mm``, which computes the reference's ``jnp.dot(a.astype(dt),
b.astype(dt), preferred_element_type=float32)``: operands rounded to the
compute dtype, products summed in float32, a float32 result. Gate math
stays float32.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch


@dataclass
class LSTMParams:
    wx: torch.Tensor  # [in_dim, 4H] input kernel (gates i|f|g|o)
    wh: torch.Tensor  # [H, 4H] recurrent kernel
    b: torch.Tensor  # [4H]
    # The fused cell kernel's padded weights per compute dtype
    # (``kernels/lstm.py``); clear after changing the weights in place.
    cache: dict = field(default_factory=dict, repr=False, compare=False)


@dataclass
class CopyLSTMParams:
    base: LSTMParams  # standard gates
    wrx: torch.Tensor  # [in_dim, H] copy-gate input kernel
    wrh: torch.Tensor  # [H, H] copy-gate recurrent kernel
    wrc: torch.Tensor  # [H, H] copy-gate memory (c*) kernel
    br: torch.Tensor  # [H]
    cache: dict = field(default_factory=dict, repr=False, compare=False)


def matmul_route(device: "str | torch.device") -> str:
    """Which route ``mm`` takes for bfloat16 operands on ``device``."""
    if torch.device(device).type == "cuda":
        return "torch.mm(bf16, bf16, out_dtype=float32)"
    return "float32 product of bf16-rounded operands"


class _MatmulF32Out(torch.autograd.Function):
    """The card's bf16 x bf16 -> float32 product (``torch.mm``/``torch.bmm``
    with ``out_dtype``) with the reference's transpose: each operand's
    gradient is a float32 product of the float32 cotangent and the other
    operand upcast (TF32 is off), rounded once to the operand's dtype —
    what JAX's transpose of ``dot(..., preferred_element_type=f32)`` on
    bf16 operands gives, and what the CPU route gets from its casts."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.dim() == 2:
            return torch.mm(a, b, out_dtype=torch.float32)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = (g @ b.float().transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = (a.float().transpose(-1, -2) @ g).to(b.dtype)
        return ga, gb


def _f32_out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 operands on the card, float32 product; through
    ``_MatmulF32Out`` when a gradient is wanted."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _MatmulF32Out.apply(a, b)
    if a.dim() == 2:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.bmm(a, b, out_dtype=torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``jnp.dot(a.astype(dt), b.astype(dt), preferred_element_type=f32)``
    for a [..., K] and b [K, M]: a float32 [..., M]. On a card, a bf16
    product with a float32 output (``torch.mm(..., out_dtype=...)``, which
    a torch without it refuses; its gradient from ``_MatmulF32Out``); on
    the CPU the float32 product of the rounded operands (bf16 values are
    exact in float32; the casts round the gradients)."""
    if dt == torch.float32:
        return a.float() @ b.float()
    a, b = a.to(dt), b.to(dt)
    if a.is_cuda:
        out = _f32_out(a.reshape(-1, a.shape[-1]), b)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return a.float() @ b.float()


def bmm(a: torch.Tensor, b: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``einsum("bij,bjk->bik", a.astype(dt), b.astype(dt),
    preferred_element_type=f32)``: ``mm`` for a [B, I, J] and b [B, J, K].
    On a card, ``torch.bmm(..., out_dtype=torch.float32)`` on the bf16
    operands; on the CPU the float32 product of the rounded operands."""
    if dt == torch.float32:
        return a.float() @ b.float()
    a, b = a.to(dt), b.to(dt)
    if a.is_cuda:
        return _f32_out(a, b)
    return a.float() @ b.float()


def lstm_gates(z: torch.Tensor, c: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """LSTM update from fp32 pre-activations z [B, 4H] (i|f|g|o)."""
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def pack_lstm(params: LSTMParams, dt: torch.dtype) -> torch.Tensor:
    """The LSTM's packed kernel, [x|h] -> 4H, in the compute dtype. Decode
    loops build it once."""
    return torch.cat([params.wx, params.wh], dim=0).to(dt)


def lstm_cell(params: LSTMParams, x, h, c, *,
              compute_dtype: torch.dtype = torch.float32,
              packed: Optional[torch.Tensor] = None):
    """One LSTM step over the packed [x|h] contraction. ``packed`` takes
    the kernel from ``pack_lstm`` instead of packing it here. Returns
    (h', c')."""
    dt = compute_dtype
    xh = torch.cat([x.to(dt), h.to(dt)], dim=-1)
    w = packed if packed is not None else pack_lstm(params, dt)
    return lstm_gates(mm(xh, w, dt) + params.b, c)


def pack_copy_lstm(params: CopyLSTMParams, dt: torch.dtype
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Copy-LSTM's two packed kernels, [x|h] -> 4H and [x|h|c*] -> H,
    in the compute dtype. Decode loops build them once."""
    w_base = torch.cat([params.base.wx, params.base.wh], dim=0)
    w_r = torch.cat([params.wrx, params.wrh, params.wrc], dim=0)
    return w_base.to(dt), w_r.to(dt)


def copy_lstm_cell(
    params: CopyLSTMParams,
    x: torch.Tensor,  # [B, in_dim]
    h: torch.Tensor,  # [B, H]
    c: torch.Tensor,  # [B, H]
    c_star: torch.Tensor,  # [B, H] SCMA-selected memory
    *,
    compute_dtype: torch.dtype = torch.float32,
    packed: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One Copy-LSTM step. ``packed`` takes the kernels from
    ``pack_copy_lstm`` instead of packing them here. Returns (h', c')."""
    dt = compute_dtype
    w_base, w_r = packed if packed is not None else pack_copy_lstm(params, dt)
    xh = torch.cat([x.to(dt), h.to(dt)], dim=-1)
    z = mm(xh, w_base, dt) + params.base.b
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    c_gen = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    xhc = torch.cat([xh, c_star.to(dt)], dim=-1)
    r = torch.sigmoid(mm(xhc, w_r, dt) + params.br)
    c_new = r * c_star + (1.0 - r) * c_gen
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_encode(
    params: LSTMParams,
    emb: torch.Tensor,  # [B, T, E]
    lengths: torch.Tensor,  # [B]
    *,
    compute_dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run an LSTM over a padded sequence, freezing (h, c) at padding steps
    (pack_padded semantics). Returns (hs, cs), [B, T, H] each; padding
    positions hold the last valid state."""
    B, T, _ = emb.shape
    H = params.wh.shape[0]
    dt = compute_dtype
    h = emb.new_zeros((B, H), dtype=torch.float32)
    c = torch.zeros_like(h)
    # The input-side product for all steps at once; the loop carries only
    # the recurrent one.
    z_x = mm(emb, params.wx, dt) + params.b
    wh = params.wh.to(dt)
    valid = (torch.arange(T, device=emb.device)[None, :]
             < lengths[:, None])  # [B, T]
    hs, cs = [], []
    for t in range(T):
        z = z_x[:, t] + mm(h, wh, dt)
        h_new, c_new = lstm_gates(z, c)
        keep = valid[:, t, None]
        h = torch.where(keep, h_new, h)
        c = torch.where(keep, c_new, c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, dim=1), torch.stack(cs, dim=1)
