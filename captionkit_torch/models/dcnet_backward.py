"""The deferred-dW backward of DCNet's teacher forcing
(``captionkit.models.dcnet_backward``) as a ``torch.autograd.Function``.

The sibling of ``models/editnet_backward.py`` (its docstring says why):
DCNet's step is one gated attention read over the encoder states and one
LSTM, so ``DCNetRecurrentSeq``'s reverse loop carries the two state
cotangents and the key-gradient accumulator, and the recurrent gate
kernel, the context gate and the attention's query kernel get their
gradients as one product each over the stacked [T·B, ·] rows after the
loop. The encoder states' gradient is Σ_t ω_t ⊗ d att_ctx_t.

Scope: the textual DCNet (``dcnet_use_visual=False``) behind
``dcnet_deferred_backward=True``; the default (False) and the visual
variant take autograd through the loop, as in the reference. Dropout keep
masks are drawn by the caller and passed in, as for EditNet.
"""

from __future__ import annotations

from typing import Optional

import torch

from captionkit_torch.models.editnet_backward import (
    context_grad,
    gates,
    mm_stacked,
    softmax_bwd,
)
from captionkit_torch.nn.cells import bmm, mm
from captionkit_torch.nn.masking import NEG_INF

#: The differentiable inputs of ``DCNetRecurrentSeq``, in argument order.
NAMES = ("w_rec_ctx", "w_rec_h", "att_wq", "att_v", "att_b", "gate_w",
         "gate_b", "att_keys", "enc_hs", "h0", "c0", "zx")


def _attention(t, mask, h, att_wq, dt):
    """Masked additive attention over the encoder states, queried by the
    step's entry h: (att_ctx fp32, omega, e [B, Tm, A] fp32)."""
    q = mm(h, att_wq, dt)
    e = torch.tanh(t["att_keys"].float() + q[:, None, :] + t["att_b"])
    scores = e @ t["att_v"]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    omega = torch.softmax(scores, dim=-1)
    att_ctx = bmm(omega[:, None, :], t["enc_hs"], t["enc_hs"].dtype)[:, 0]
    return att_ctx, omega, e


class DCNetRecurrentSeq(torch.autograd.Function):
    """outs [T, B, H] (the dropped-out decoder h of every step) given zx
    [T, B, 4H] (the emb side of the gate product plus the bias) and the
    initial state.

    ``apply(dt, drop_rate, mask, keep, *tensors)`` as
    ``editnet_backward.RecurrentSeq``, with the tensors of ``NAMES``."""

    @staticmethod
    def forward(ctx, dt, drop_rate, mask, keep, *tensors):
        t = dict(zip(NAMES, tensors))
        w_rec = torch.cat([t["w_rec_ctx"], t["w_rec_h"]], 0).to(dt)
        att_wq, gate_w = t["att_wq"].to(dt), t["gate_w"].to(dt)
        h, c = t["h0"], t["c0"]
        outs, states, zs, omegas = [], [], [], []
        for s in range(t["zx"].shape[0]):
            att_ctx, omega, _ = _attention(t, mask, h, att_wq, dt)
            g = torch.sigmoid(mm(h, gate_w, dt) + t["gate_b"])
            x_rec = torch.cat([g * att_ctx, h], dim=-1)
            z = t["zx"][s] + mm(x_rec, w_rec, dt)
            i, f, gg, o = gates(z)
            states.append(torch.stack([h, c]))
            c = f * c + i * gg
            h = o * torch.tanh(c)
            out = h
            if keep is not None:
                out = torch.where(keep[s], h / (1.0 - drop_rate),
                                  torch.zeros_like(h))
            outs.append(out)
            zs.append(z)
            omegas.append(omega)
        ctx.dt, ctx.drop_rate = dt, drop_rate
        ctx.save_for_backward(mask, keep, torch.stack(states),
                              torch.stack(zs), torch.stack(omegas), *tensors)
        return torch.stack(outs)

    @staticmethod
    def backward(ctx, d_outs):
        mask, keep, states_in, z_st, omega_st, *tensors = ctx.saved_tensors
        dt, drop_rate = ctx.dt, ctx.drop_rate
        t = dict(zip(NAMES, tensors))
        w_rec = torch.cat([t["w_rec_ctx"], t["w_rec_h"]], 0).to(dt)
        att_wq, gate_w = t["att_wq"].to(dt), t["gate_w"].to(dt)
        T, B, H = d_outs.shape
        d_outs = d_outs.float()
        dev = d_outs.device
        em = {k: torch.empty((T, B, n), device=dev) for k, n in (
            ("dz", 4 * H), ("dgpre", H), ("dq", t["att_wq"].shape[1]),
            ("datt_ctx", H), ("part", H))}
        A = t["att_v"].shape[0]
        dv = torch.zeros(A, device=dev)
        db = torch.zeros(A, device=dev)
        d_att_keys = torch.zeros(t["att_keys"].shape, device=dev)
        dh_n = torch.zeros((B, H), device=dev)
        dc_n = torch.zeros_like(dh_n)
        for s in range(T - 1, -1, -1):
            h_in, c_in = states_in[s]
            i, f, gg, o = gates(z_st[s])
            c = f * c_in + i * gg
            tc = torch.tanh(c)
            att_ctx, _, e = _attention(t, mask, h_in, att_wq, dt)
            omega = omega_st[s]
            g = torch.sigmoid(mm(h_in, gate_w, dt) + t["gate_b"])

            d_out = d_outs[s]
            if keep is not None:
                d_out = torch.where(keep[s], d_out / (1.0 - drop_rate),
                                    torch.zeros_like(d_out))
            dh = dh_n + d_out

            # LSTM
            do = dh * tc
            dc = dc_n + dh * o * (1.0 - tc * tc)
            dc_n = dc * f
            dz = torch.cat([dc * gg * i * (1.0 - i),
                            dc * c_in * f * (1.0 - f),
                            dc * i * (1.0 - gg * gg),
                            do * o * (1.0 - o)], dim=-1)
            dx_rec = mm(dz, w_rec.transpose(0, 1), dt)
            dpart = dx_rec[:, :H]
            dh_prev = dx_rec[:, H:]

            # gated attention
            dgpre = dpart * att_ctx * g * (1.0 - g)
            datt_ctx = dpart * g
            dh_prev = dh_prev + mm(dgpre, gate_w.transpose(0, 1), dt)
            domega = bmm(t["enc_hs"], datt_ctx[:, :, None],
                         t["enc_hs"].dtype)[..., 0]
            dscores = softmax_bwd(omega, domega)
            dtanh = dscores[:, :, None] * t["att_v"] * (1.0 - e * e)
            dq = dtanh.sum(dim=1)
            dh_n = dh_prev + mm(dq, att_wq.transpose(0, 1), dt)
            d_att_keys += dtanh
            dv += (dscores[:, :, None] * e).sum(dim=(0, 1))
            db += dtanh.sum(dim=(0, 1))
            for k, v in (("dz", dz), ("dgpre", dgpre), ("dq", dq),
                         ("datt_ctx", datt_ctx), ("part", g * att_ctx)):
                em[k][s] = v

        h_in_st = states_in[:, 0]
        x_rec_st = torch.cat([em["part"], h_in_st], dim=-1)
        d_w_rec = mm_stacked(x_rec_st, em["dz"], dt)
        need = dict(zip(NAMES, ctx.needs_input_grad[4:]))
        grads = {
            "w_rec_ctx": d_w_rec[:H],
            "w_rec_h": d_w_rec[H:],
            "att_wq": mm_stacked(h_in_st, em["dq"], dt),
            "att_v": dv,
            "att_b": db,
            "gate_w": mm_stacked(h_in_st, em["dgpre"], dt),
            "gate_b": em["dgpre"].sum(dim=(0, 1)),
            "att_keys": d_att_keys.to(t["att_keys"].dtype),
            "enc_hs": (context_grad(omega_st, em["datt_ctx"]).to(
                t["enc_hs"].dtype) if need["enc_hs"] else None),
            "h0": dh_n,
            "c0": dc_n,
            "zx": em["dz"],
        }
        return (None, None, None, None,
                *(grads[n] if need[n] else None for n in NAMES))


def dcnet_recurrent_seq(dt: torch.dtype, drop_rate: float,
                        mask: torch.Tensor, keep: Optional[torch.Tensor],
                        tensors: dict) -> torch.Tensor:
    """``DCNetRecurrentSeq.apply`` with the tensors given by name."""
    return DCNetRecurrentSeq.apply(dt, drop_rate, mask, keep,
                                   *(tensors[n] for n in NAMES))
