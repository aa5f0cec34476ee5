"""EditNet (Sammani & Melas-Kyriazi, "Show, Edit and Tell", CVPR 2020):
its weights, the port's model, the plain float32 reference, the head and
the FLOPs of a caption.

Reference: an LSTM encoder over the existing caption keeps its hidden
states (SCMA's keys) and cell states (SCMA's copy pool); the attention
LSTM reads [emb ; mean of the regions ; h_lang] with h_att (``att_lstm/wx``
rows packed [emb | v_mean | h_lang]); additive attention over the regions
gives v_hat, gated by sigmoid(h_att W + b); soft SCMA over the encoder's
states gives c*; the Copy-LSTM reads [v_hat ; h_att] with h_lang and
blends c* into its cell through the copy gate; the logits are h_lang W + b.
"""

from __future__ import annotations

import torch

from ckbench import flops, inputs
from ckbench.reference.model import (
    attend, encode_caption, length_mask, lstm_step)


def weight_table(m: dict) -> list[tuple[str, tuple, float]]:
    """(checkpoint name, shape, uniform scale; 0 = zeros) of every array:
    the embedding at 0.1, zero gate and head biases."""
    E, H, A, V, F = (m["emb_dim"], m["hidden_dim"], m["att_dim"],
                     m["vocab_size"], m["feat_dim"])
    s = H ** -0.5
    return ([("embedding", (V, E), 0.1)] + inputs.lstm_arrays("encoder", E, H)
            + inputs.lstm_arrays("att_lstm", E + F + H, H)
            + inputs.attention_arrays("vis_attention", F, H, A)
            + [("vis_gate_w", (H, F), s), ("vis_gate_b", (F,), 0.0)]
            + inputs.attention_arrays("scma", H, H, A)
            + inputs.lstm_arrays("lang_lstm/base", F + H, H)
            + [("lang_lstm/wrx", (F + H, H), s),
               ("lang_lstm/wrh", (H, H), s),
               ("lang_lstm/wrc", (H, H), s), ("lang_lstm/br", (H,), s),
               ("fc_w", (H, V), s), ("fc_b", (V,), 0.0)])


def make_weights(m: dict, seed: int, device) -> dict:
    """{checkpoint name: float32 tensor on ``device``} from ``seed``."""
    return inputs.uniform_weights(weight_table(m), seed, device)


def program(model: dict, weights: dict, device):
    """The port's EditNet over the flat weights themselves (no copy)."""
    from captionkit_torch.config import ModelConfig
    from captionkit_torch.models import get_model
    from captionkit_torch.params import editnet_params_from_tensors

    cfg = ModelConfig(**model)
    params = editnet_params_from_tensors(weights)
    return cfg, get_model(cfg), params


def head(weights) -> tuple:
    return weights["fc_w"], weights["fc_b"]


def reads_features(m: dict) -> bool:
    return True


def encode(w, features, existing, lengths):
    hs, cs = encode_caption(w, existing, lengths)
    T = existing.shape[1]
    return {
        "features": features,
        "vis_keys": w.mm(features, w["vis_attention/w_enc"]),
        "v_mean": features.mean(1),
        "enc_cs": cs,
        "scma_keys": w.mm(hs, w["scma/w_enc"]),
        "mask": length_mask(lengths, T),
    }


def state0(w, ctx):
    B, H = ctx["v_mean"].shape[0], w["fc_w"].shape[0]
    z = ctx["v_mean"].new_zeros(B, H)
    return (z, z.clone(), z.clone(), z.clone())


def step(w, ctx, state, token):
    """(state, logits [B, V]) of one step; state (h_att, c_att, h_lang,
    c_lang)."""
    h_att, c_att, h_lang, c_lang = state
    emb = w["embedding"][token.long()]
    x = torch.cat([emb, ctx["v_mean"], h_lang], -1)
    h_att, c_att = lstm_step(w, "att_lstm", x, h_att, c_att)
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


reference = (encode, state0, step)


def encode_flops(m: dict, t: int) -> int:
    """One image's encode: the caption encoder over ``t`` positions, the
    text and visual keys, the v_mean term of the attention LSTM."""
    E, H, A, F, R = (m["emb_dim"], m["hidden_dim"], m["att_dim"],
                     m["feat_dim"], m["num_regions"])
    return (t * flops.lstm(E, H) + 2 * t * H * A
            + 2 * R * F * A + 2 * F * 4 * H)


def step_flops(m: dict, t: int) -> int:
    """One decode row's step, to the vocab head's logits."""
    E, H, A, F, R, V = (m["emb_dim"], m["hidden_dim"], m["att_dim"],
                        m["feat_dim"], m["num_regions"], m["vocab_size"])
    att_lstm = flops.lstm(E + H, H)  # [emb | h_lang] and h_att; v_mean hoisted
    queries = 2 * H * 2 * A  # visual and SCMA queries
    reads = 2 * R * F + 2 * t * H  # alpha -> v_hat, beta -> c*
    gate = 2 * H * F
    lang = flops.lstm(F + H, H) + 2 * (F + 3 * H) * H  # Copy-LSTM + copy gate
    return att_lstm + queries + reads + gate + lang + 2 * H * V


def caption_flops(m: dict, *, beam: int, steps: int, t: int) -> int:
    """One caption of a ``beam``-wide decode of ``steps`` steps over an
    existing caption of ``t`` positions."""
    return encode_flops(m, t) + steps * beam * step_flops(m, t)
