"""Plain float32 EditNet and DCNet (Sammani & Melas-Kyriazi, "Show, Edit
and Tell", CVPR 2020): the encode and one decode step, in plain PyTorch.

The weights are the flat arrays of the reference checkpoint, by name
(``embedding``, ``encoder/wx``, ``att_lstm/wx`` ...): [in, out] matrices,
LSTM gates ordered i|f|g|o with one bias, ``att_lstm/wx`` rows packed
[emb | v_mean | h_lang], ``decoder/wx`` rows packed [emb | context]. No
packed, padded or rounded copy is made: every product is a float32
product of the float32 weights (``Weights.mm``), and TF32 is off.

EditNet: an LSTM encoder over the existing caption keeps its hidden
states (SCMA's keys) and cell states (SCMA's copy pool); the
attention LSTM reads [emb ; mean of the regions ; h_lang] with h_att;
additive attention over the regions gives v_hat, gated by
sigmoid(h_att W + b); soft SCMA over the encoder's states gives c*; the
Copy-LSTM reads [v_hat ; h_att] with h_lang and blends c* into its cell
through the copy gate; the logits are h_lang W + b.

DCNet (textual): the same encoder; the decoder's state starts at a
Linear of the encoder's last state; additive attention over the
encoder's hidden states with the decoder's h, gated by sigmoid(h W + b);
the decoder LSTM reads [emb ; gated context] with h; the logits are
h W + b.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class Weights(dict):
    """The flat arrays by name, and ``mm``, the product every matrix
    multiplication of the model goes through: float32 by default."""

    def __init__(self, arrays, mm=torch.matmul):
        super().__init__(arrays)
        self.mm = mm


def fp8_mm(a, b):
    """The product of ``a`` and ``b`` rounded to float8 e4m3 (each scaled
    by its own largest magnitude), summed in float32: the control's
    precision, one step below the configurations' bfloat16."""
    return _fp8(a) @ _fp8(b)


def _fp8(x):
    s = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _gates(z, c):
    i, f, g, o = z.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _lstm_step(w, prefix, x, h, c):
    z = (w.mm(x, w[f"{prefix}/wx"]) + w.mm(h, w[f"{prefix}/wh"])
         + w[f"{prefix}/b"])
    return _gates(z, c)


def encode_caption(w, existing, lengths):
    """The caption encoder over ids [B, T], frozen past each length:
    (hs, cs), [B, T, H] each."""
    emb = w["embedding"][existing.long()]
    B, T, _ = emb.shape
    H = w["encoder/wh"].shape[0]
    h = emb.new_zeros(B, H)
    c = emb.new_zeros(B, H)
    hs, cs = [], []
    for t in range(T):
        h2, c2 = _lstm_step(w, "encoder", emb[:, t], h, c)
        keep = (t < lengths)[:, None]
        h = torch.where(keep, h2, h)
        c = torch.where(keep, c2, c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, 1), torch.stack(cs, 1)


def attend(w, prefix, keys, values, query, mask=None):
    """Additive attention: keys [B, N, A] projected, values [B, N, D],
    query [B, Q]; (context [B, D], weights [B, N])."""
    q = w.mm(query, w[f"{prefix}/w_q"])
    e = torch.tanh(keys + q[:, None, :] + w[f"{prefix}/b"])
    scores = w.mm(e, w[f"{prefix}/v"])
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, -1e9))
    weights = torch.softmax(scores, dim=-1)
    return w.mm(weights[:, None, :], values)[:, 0], weights


def _mask(lengths, T):
    return torch.arange(T, device=lengths.device)[None] < lengths[:, None]


def editnet_encode(w, features, existing, lengths):
    hs, cs = encode_caption(w, existing, lengths)
    T = existing.shape[1]
    return {
        "features": features,
        "vis_keys": w.mm(features, w["vis_attention/w_enc"]),
        "v_mean": features.mean(1),
        "enc_cs": cs,
        "scma_keys": w.mm(hs, w["scma/w_enc"]),
        "mask": _mask(lengths, T),
    }


def editnet_state(w, ctx):
    B, H = ctx["v_mean"].shape[0], w["fc_w"].shape[0]
    z = ctx["v_mean"].new_zeros(B, H)
    return (z, z.clone(), z.clone(), z.clone())


def editnet_step(w, ctx, state, token):
    """(state, logits [B, V]) of one step; state (h_att, c_att, h_lang,
    c_lang)."""
    h_att, c_att, h_lang, c_lang = state
    emb = w["embedding"][token.long()]
    x = torch.cat([emb, ctx["v_mean"], h_lang], -1)
    h_att, c_att = _lstm_step(w, "att_lstm", x, h_att, c_att)
    v_hat, _ = attend(w, "vis_attention", ctx["vis_keys"], ctx["features"],
                      h_att)
    v_hat = torch.sigmoid(w.mm(h_att, w["vis_gate_w"]) + w["vis_gate_b"]) \
        * v_hat
    c_star, _ = attend(w, "scma", ctx["scma_keys"], ctx["enc_cs"], h_att,
                       ctx["mask"])
    x_lang = torch.cat([v_hat, h_att], -1)
    z = (w.mm(x_lang, w["lang_lstm/base/wx"])
         + w.mm(h_lang, w["lang_lstm/base/wh"]) + w["lang_lstm/base/b"])
    i, f, g, o = z.chunk(4, dim=-1)
    c_gen = torch.sigmoid(f) * c_lang + torch.sigmoid(i) * torch.tanh(g)
    r = torch.sigmoid(w.mm(x_lang, w["lang_lstm/wrx"])
                      + w.mm(h_lang, w["lang_lstm/wrh"])
                      + w.mm(c_star, w["lang_lstm/wrc"]) + w["lang_lstm/br"])
    c_lang = r * c_star + (1.0 - r) * c_gen
    h_lang = torch.sigmoid(o) * torch.tanh(c_lang)
    logits = w.mm(h_lang, w["fc_w"]) + w["fc_b"]
    return (h_att, c_att, h_lang, c_lang), logits


def dcnet_encode(w, features, existing, lengths):
    hs, cs = encode_caption(w, existing, lengths)
    T = existing.shape[1]
    return {
        "enc_hs": hs,
        "keys": w.mm(hs, w["attention/w_enc"]),
        "mask": _mask(lengths, T),
        "h0": w.mm(hs[:, -1], w["init_h_w"]) + w["init_h_b"],
        "c0": w.mm(cs[:, -1], w["init_c_w"]) + w["init_c_b"],
    }


def dcnet_state(w, ctx):
    return (ctx["h0"], ctx["c0"])


def dcnet_step(w, ctx, state, token):
    h, c = state
    emb = w["embedding"][token.long()]
    att_ctx, _ = attend(w, "attention", ctx["keys"], ctx["enc_hs"], h,
                        ctx["mask"])
    gated = torch.sigmoid(w.mm(h, w["gate_w"]) + w["gate_b"]) * att_ctx
    h, c = _lstm_step(w, "decoder", torch.cat([emb, gated], -1), h, c)
    return (h, c), w.mm(h, w["fc_w"]) + w["fc_b"]


MODELS = {
    "editnet": (editnet_encode, editnet_state, editnet_step),
    "dcnet": (dcnet_encode, dcnet_state, dcnet_step),
}


def expand(ctx: dict, k: int) -> dict:
    """Every per-image context tensor repeated for k rows an image."""
    return {n: t.repeat_interleave(k, dim=0) for n, t in ctx.items()}
