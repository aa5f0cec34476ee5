"""The deferred-dW backward of EditNet's teacher forcing
(``captionkit.models.editnet_backward``) as a ``torch.autograd.Function``.

Autograd through a Python loop of steps accumulates the gradient of every
weight the loop reads once per step: a read and a write of each weight
gradient (the Copy-LSTM's, the recurrent gate kernel's, the attention
query kernels') and of the attention keys at every timestep.
``RecurrentSeq`` runs the same recurrence forward, keeps what the
reference's ``_recurrent_seq_fwd`` keeps (each step's input state, the
gate pre-activations z, z2, r_pre and the attention weights α, β), and its
backward walks the steps in reverse carrying only the four state
cotangents and the two key-gradient accumulators. Each step's product
cotangents (dz, dz2, dr_pre, dq, ...) go into [T, B, ·] stacks, and every
large weight gradient is one product over the stacked [T·B, ·] rows after
the loop:

    dW = sum_t x_t^T dz_t = reshape(x, [T·B, in])^T @ reshape(dz, [T·B, out])

with the reference's casts: both operands rounded to the compute dtype,
float32 sums (``nn.cells.mm``). The per-image context gradients use their
rank-one factors (d_features = Σ_t α_t ⊗ dctx_t, d_enc_cs = Σ_t β_t ⊗
dc*_t).

Scope: soft SCMA; hard SCMA takes autograd through the loop
(``models/editnet.py::forward_seq``), as in the reference. Dropout: the
caller draws every step's keep mask before the forward and passes them in
([T, B, H] bool, 5.5 MB at batch 256 and 21 steps); the backward reads the
same masks. Stashing them costs less than the step's other stashes (an
[B, 4H] fp32 pre-activation alone is 4 MB), and it needs no replay of the
generator's stream in reverse order.
"""

from __future__ import annotations

from typing import Optional

import torch

from captionkit_torch.nn.cells import bmm, mm
from captionkit_torch.nn.masking import NEG_INF

#: The differentiable inputs of ``RecurrentSeq``, in argument order.
NAMES = (
    "w_rec_lang", "w_rec_att",
    "lang_wx", "lang_wh", "lang_b", "lang_wrx", "lang_wrh", "lang_wrc",
    "lang_br",
    "vis_wq", "vis_v", "vis_b", "gate_w", "gate_b",
    "scma_wq", "scma_v", "scma_b",
    "vis_keys", "features", "scma_keys", "enc_cs",
    "h_att0", "c_att0", "h_lang0", "c_lang0",
    "zx",
)

#: A planted fault for the gradient check's test of itself: the name of a
#: weight whose gradient the backward then drops (returns as zeros).
#: ``None`` in every real run.
PLANTED_FAULT: Optional[str] = None


def gates(z: torch.Tensor):
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    return torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)


def softmax_bwd(w: torch.Tensor, dw: torch.Tensor) -> torch.Tensor:
    """d scores of softmax(scores) given the weights w and dL/dw."""
    return w * (dw - (w * dw).sum(dim=-1, keepdim=True))


def mm_stacked(a: torch.Tensor, b: torch.Tensor, dt: torch.dtype
               ) -> torch.Tensor:
    """``einsum("tbi,tbj->ij", a.astype(dt), b.astype(dt),
    preferred_element_type=f32)``: one product over the T·B rows."""
    return mm(a.reshape(-1, a.shape[-1]).transpose(0, 1),
              b.reshape(-1, b.shape[-1]), dt)


def context_grad(w_st: torch.Tensor, d_st: torch.Tensor) -> torch.Tensor:
    """``einsum("tbn,tbd->bnd", w, d)`` in float32: the gradient of a
    per-image attention value table from the steps' weights and read
    cotangents."""
    return torch.bmm(w_st.permute(1, 2, 0).float(),
                     d_st.permute(1, 0, 2).float())


def _attend(keys, q, b, v, mask=None):
    """e = tanh(keys + q + b) [B, N, A] fp32 and the softmax weights."""
    e = torch.tanh(keys.float() + q[:, None, :] + b)
    scores = e @ v
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    return e, torch.softmax(scores, dim=-1)


def _read(w: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``einsum("bn,bnd->bd", w.astype(values.dtype), values, f32)``."""
    return bmm(w[:, None, :], values, values.dtype)[:, 0]


class _Weights:
    """The step's weights rounded to the compute dtype, packed as the
    reference packs them."""

    def __init__(self, t: dict, dt: torch.dtype):
        self.w_rec = torch.cat([t["w_rec_lang"], t["w_rec_att"]], 0).to(dt)
        self.w_base = torch.cat([t["lang_wx"], t["lang_wh"]], 0).to(dt)
        self.w_r = torch.cat([t["lang_wrx"], t["lang_wrh"], t["lang_wrc"]],
                             0).to(dt)
        self.vis_wq = t["vis_wq"].to(dt)
        self.gate_w = t["gate_w"].to(dt)
        self.scma_wq = t["scma_wq"].to(dt)


def _att_lstm(t, w, dt, h_att_in, c_att_in, h_lang_in, zx_t):
    hh = torch.cat([h_lang_in.to(dt), h_att_in.to(dt)], dim=-1)
    return zx_t + mm(hh, w.w_rec, dt)


def _step_forward(t, w, dt, mask, state, z):
    """The step from its gate pre-activation z. Returns
    (state', h_lang, z2, rpre, alpha, beta)."""
    h_att_in, c_att_in, h_lang_in, c_lang_in = state
    i, f, g, o = gates(z)
    c_att = f * c_att_in + i * g
    h_att = o * torch.tanh(c_att)
    qv = mm(h_att, w.vis_wq, dt)
    _, alpha = _attend(t["vis_keys"], qv, t["vis_b"], t["vis_v"])
    ctx_v = _read(alpha, t["features"])
    g_v = torch.sigmoid(mm(h_att, w.gate_w, dt) + t["gate_b"])
    v_hat = (g_v * ctx_v.to(dt).float()).to(dt)
    qs = mm(h_att, w.scma_wq, dt)
    _, beta = _attend(t["scma_keys"], qs, t["scma_b"], t["scma_v"], mask)
    c_star = _read(beta, t["enc_cs"])
    xh = torch.cat([v_hat, h_att.to(dt), h_lang_in.to(dt)], dim=-1)
    z2 = mm(xh, w.w_base, dt) + t["lang_b"]
    i2, f2, g2, o2 = gates(z2)
    c_gen = f2 * c_lang_in + i2 * g2
    xhc = torch.cat([xh, c_star.to(dt)], dim=-1)
    rpre = mm(xhc, w.w_r, dt) + t["lang_br"]
    r = torch.sigmoid(rpre)
    c_lang = r * c_star + (1.0 - r) * c_gen
    h_lang = o2 * torch.tanh(c_lang)
    return (h_att, c_att, h_lang, c_lang), z2, rpre, alpha, beta


class RecurrentSeq(torch.autograd.Function):
    """outs [T, B, H] (the dropped-out h_lang of every step) of EditNet's
    recurrence, given zx [T, B, 4H] (the input side of the att-LSTM's gate
    product plus its v_mean term and bias) and the initial state.

    ``apply(dt, drop_rate, mask, keep, *tensors)``: the compute dtype, the
    dropout rate, the caption mask [B, Tm] bool, the keep masks [T, B, H]
    bool (None without dropout), then the tensors of ``NAMES``."""

    @staticmethod
    def forward(ctx, dt, drop_rate, mask, keep, *tensors):
        t = dict(zip(NAMES, tensors))
        w = _Weights(t, dt)
        zx = t["zx"]
        T = zx.shape[0]
        state = (t["h_att0"], t["c_att0"], t["h_lang0"], t["c_lang0"])
        outs, states, zs, z2s, rpres, alphas, betas = ([] for _ in range(7))
        for s in range(T):
            z = _att_lstm(t, w, dt, *state[:3], zx[s])
            new, z2, rpre, alpha, beta = _step_forward(t, w, dt, mask,
                                                       state, z)
            out = new[2]
            if keep is not None:
                out = torch.where(keep[s], out / (1.0 - drop_rate),
                                  torch.zeros_like(out))
            states.append(torch.stack(state))
            zs.append(z)
            z2s.append(z2)
            rpres.append(rpre)
            alphas.append(alpha)
            betas.append(beta)
            outs.append(out)
            state = new
        ctx.dt, ctx.drop_rate = dt, drop_rate
        ctx.save_for_backward(
            mask, keep, torch.stack(states), torch.stack(zs),
            torch.stack(z2s), torch.stack(rpres), torch.stack(alphas),
            torch.stack(betas), *tensors)
        return torch.stack(outs)

    @staticmethod
    def backward(ctx, d_outs):
        (mask, keep, states_in, z_st, z2_st, rpre_st, alpha_st, beta_st,
         *tensors) = ctx.saved_tensors
        dt, drop_rate = ctx.dt, ctx.drop_rate
        t = dict(zip(NAMES, tensors))
        w = _Weights(t, dt)
        T, B, H = d_outs.shape
        Fdim = t["features"].shape[-1]
        in_dim = Fdim + H
        d_outs = d_outs.float()
        dev = d_outs.device

        def stack(*shape):
            return torch.empty((T, *shape), dtype=torch.float32, device=dev)

        em = {k: stack(B, n) for k, n in (
            ("dz", 4 * H), ("dz2", 4 * H), ("drpre", H),
            ("dqv", t["vis_wq"].shape[1]), ("dqs", t["scma_wq"].shape[1]),
            ("dgpre", Fdim), ("dctx_v", Fdim), ("dc_star", H),
            ("h_att", H), ("c_star", H))}
        em["v_hat"] = torch.empty((T, B, Fdim), dtype=dt, device=dev)
        A = t["vis_v"].shape[0]
        dv_v = torch.zeros(A, device=dev)
        db_v = torch.zeros(A, device=dev)
        dv_s = torch.zeros(A, device=dev)
        db_s = torch.zeros(A, device=dev)
        d_vis_keys = torch.zeros(t["vis_keys"].shape, device=dev)
        d_scma_keys = torch.zeros(t["scma_keys"].shape, device=dev)
        dh_att_n = torch.zeros((B, H), device=dev)
        dc_att_n = torch.zeros_like(dh_att_n)
        dh_lang_n = torch.zeros_like(dh_att_n)
        dc_lang_n = torch.zeros_like(dh_att_n)
        for s in range(T - 1, -1, -1):
            h_att_in, c_att_in, h_lang_in, c_lang_in = states_in[s]
            # Recompute the step's internals from the stash.
            i, f, g, o = gates(z_st[s])
            c_att = f * c_att_in + i * g
            tc_att = torch.tanh(c_att)
            h_att = o * tc_att
            alpha, beta = alpha_st[s], beta_st[s]
            qv = mm(h_att, w.vis_wq, dt)
            e_v = torch.tanh(t["vis_keys"].float() + qv[:, None, :]
                             + t["vis_b"])
            ctx_v = _read(alpha, t["features"])
            g_v = torch.sigmoid(mm(h_att, w.gate_w, dt) + t["gate_b"])
            v_hat = (g_v * ctx_v.to(dt).float()).to(dt)
            qs = mm(h_att, w.scma_wq, dt)
            e_s = torch.tanh(t["scma_keys"].float() + qs[:, None, :]
                             + t["scma_b"])
            c_star = _read(beta, t["enc_cs"])
            i2, f2, g2, o2 = gates(z2_st[s])
            c_gen = f2 * c_lang_in + i2 * g2
            r = torch.sigmoid(rpre_st[s])
            c_lang = r * c_star + (1.0 - r) * c_gen
            tc_lang = torch.tanh(c_lang)

            d_out = d_outs[s]
            if keep is not None:
                d_out = torch.where(keep[s], d_out / (1.0 - drop_rate),
                                    torch.zeros_like(d_out))
            dh_lang = dh_lang_n + d_out

            # Copy-LSTM
            do2 = dh_lang * tc_lang
            dc_lang = dc_lang_n + dh_lang * o2 * (1.0 - tc_lang * tc_lang)
            dr = dc_lang * (c_star - c_gen)
            dc_star = dc_lang * r
            dc_gen = dc_lang * (1.0 - r)
            drpre = dr * r * (1.0 - r)
            dc_lang_n = dc_gen * f2
            dz2 = torch.cat([dc_gen * g2 * i2 * (1.0 - i2),
                             dc_gen * c_lang_in * f2 * (1.0 - f2),
                             dc_gen * i2 * (1.0 - g2 * g2),
                             do2 * o2 * (1.0 - o2)], dim=-1)
            dxhc = mm(drpre, w.w_r.transpose(0, 1), dt)
            dxh = mm(dz2, w.w_base.transpose(0, 1), dt)
            dx_lang = dxh[:, :in_dim] + dxhc[:, :in_dim]
            dh_lang_prev = dxh[:, in_dim:] + dxhc[:, in_dim:in_dim + H]
            dc_star = dc_star + dxhc[:, in_dim + H:]
            dv_hat = dx_lang[:, :Fdim]
            dh_att = dh_att_n + dx_lang[:, Fdim:]

            # SCMA (soft)
            dbeta = bmm(t["enc_cs"], dc_star[:, :, None],
                        t["enc_cs"].dtype)[..., 0]
            dsc_s = softmax_bwd(beta, dbeta)
            dtanh_s = dsc_s[:, :, None] * t["scma_v"] * (1.0 - e_s * e_s)
            dqs = dtanh_s.sum(dim=1)
            dh_att = dh_att + mm(dqs, w.scma_wq.transpose(0, 1), dt)
            d_scma_keys += dtanh_s
            dv_s += (dsc_s[:, :, None] * e_s).sum(dim=(0, 1))
            db_s += dtanh_s.sum(dim=(0, 1))

            # visual gate and attention
            dgpre = dv_hat * ctx_v * g_v * (1.0 - g_v)
            dctx_v = dv_hat * g_v
            dh_att = dh_att + mm(dgpre, w.gate_w.transpose(0, 1), dt)
            dalpha = bmm(t["features"], dctx_v[:, :, None],
                         t["features"].dtype)[..., 0]
            dsc_v = softmax_bwd(alpha, dalpha)
            dtanh_v = dsc_v[:, :, None] * t["vis_v"] * (1.0 - e_v * e_v)
            dqv = dtanh_v.sum(dim=1)
            dh_att = dh_att + mm(dqv, w.vis_wq.transpose(0, 1), dt)
            d_vis_keys += dtanh_v
            dv_v += (dsc_v[:, :, None] * e_v).sum(dim=(0, 1))
            db_v += dtanh_v.sum(dim=(0, 1))

            # att-LSTM
            do = dh_att * tc_att
            dc_att = dc_att_n + dh_att * o * (1.0 - tc_att * tc_att)
            dc_att_n = dc_att * f
            dz = torch.cat([dc_att * g * i * (1.0 - i),
                            dc_att * c_att_in * f * (1.0 - f),
                            dc_att * i * (1.0 - g * g),
                            do * o * (1.0 - o)], dim=-1)
            dhh = mm(dz, w.w_rec.transpose(0, 1), dt)
            dh_lang_n = dh_lang_prev + dhh[:, :H]
            dh_att_n = dhh[:, H:]

            for k, v in (("dz", dz), ("dz2", dz2), ("drpre", drpre),
                         ("dqv", dqv), ("dqs", dqs), ("dgpre", dgpre),
                         ("dctx_v", dctx_v), ("dc_star", dc_star),
                         ("v_hat", v_hat), ("h_att", h_att),
                         ("c_star", c_star)):
                em[k][s] = v

        # The deferred weight gradients: one product each over T·B rows.
        h_att_in_st, h_lang_in_st = states_in[:, 0], states_in[:, 2]
        hh_st = torch.cat([h_lang_in_st.to(dt), h_att_in_st.to(dt)], dim=-1)
        d_w_rec = mm_stacked(hh_st, em["dz"], dt)
        x_lang_st = torch.cat([em["v_hat"].float(), em["h_att"]], dim=-1)
        need = dict(zip(NAMES, ctx.needs_input_grad[4:]))
        g = {
            "w_rec_lang": d_w_rec[:H],
            "w_rec_att": d_w_rec[H:],
            "lang_wx": mm_stacked(x_lang_st, em["dz2"], dt),
            "lang_wh": mm_stacked(h_lang_in_st, em["dz2"], dt),
            "lang_b": em["dz2"].sum(dim=(0, 1)),
            "lang_wrx": mm_stacked(x_lang_st, em["drpre"], dt),
            "lang_wrh": mm_stacked(h_lang_in_st, em["drpre"], dt),
            "lang_wrc": mm_stacked(em["c_star"], em["drpre"], dt),
            "lang_br": em["drpre"].sum(dim=(0, 1)),
            "vis_wq": mm_stacked(em["h_att"], em["dqv"], dt),
            "vis_v": dv_v,
            "vis_b": db_v,
            "gate_w": mm_stacked(em["h_att"], em["dgpre"], dt),
            "gate_b": em["dgpre"].sum(dim=(0, 1)),
            "scma_wq": mm_stacked(em["h_att"], em["dqs"], dt),
            "scma_v": dv_s,
            "scma_b": db_s,
            "vis_keys": d_vis_keys.to(t["vis_keys"].dtype),
            "features": (context_grad(alpha_st, em["dctx_v"]).to(
                t["features"].dtype) if need["features"] else None),
            "scma_keys": d_scma_keys.to(t["scma_keys"].dtype),
            "enc_cs": (context_grad(beta_st, em["dc_star"]).to(
                t["enc_cs"].dtype) if need["enc_cs"] else None),
            "h_att0": dh_att_n,
            "c_att0": dc_att_n,
            "h_lang0": dh_lang_n,
            "c_lang0": dc_lang_n,
            "zx": em["dz"],
        }
        if PLANTED_FAULT is not None:
            g[PLANTED_FAULT] = torch.zeros_like(g[PLANTED_FAULT])
        return (None, None, None, None,
                *(g[n] if need[n] else None for n in NAMES))


def recurrent_seq(dt: torch.dtype, drop_rate: float, mask: torch.Tensor,
                  keep: Optional[torch.Tensor], tensors: dict
                  ) -> torch.Tensor:
    """``RecurrentSeq.apply`` with the tensors given by name."""
    return RecurrentSeq.apply(dt, drop_rate, mask, keep,
                              *(tensors[n] for n in NAMES))
