"""The textual DCNet (Sammani & Melas-Kyriazi, "Show, Edit and Tell", CVPR
2020): its weights, the port's model, the plain float32 reference, the
head and the FLOPs of a caption.

Reference: the caption encoder of EditNet; the decoder's state starts at
a Linear of the encoder's last state; additive attention over the
encoder's hidden states with the decoder's h, gated by sigmoid(h W + b);
the decoder LSTM reads [emb ; gated context] with h (``decoder/wx`` rows
packed [emb | context]); the logits are h W + b. The visual DCNet
(``dcnet_use_visual``) has no weight table here.
"""

from __future__ import annotations

import torch

from ckbench import flops, inputs
from ckbench.reference.model import (
    attend, encode_caption, length_mask, lstm_step)


def weight_table(m: dict) -> list[tuple[str, tuple, float]]:
    """(checkpoint name, shape, uniform scale; 0 = zeros) of every array:
    the embedding at 0.1, zero gate, head and init biases."""
    if m.get("dcnet_use_visual"):
        raise ValueError("the visual DCNet has no weight table here")
    E, H, A, V = (m["emb_dim"], m["hidden_dim"], m["att_dim"],
                  m["vocab_size"])
    s = H ** -0.5
    return ([("embedding", (V, E), 0.1)] + inputs.lstm_arrays("encoder", E, H)
            + inputs.attention_arrays("attention", H, H, A)
            + [("gate_w", (H, H), s), ("gate_b", (H,), 0.0)]
            + inputs.lstm_arrays("decoder", E + H, H)
            + [("fc_w", (H, V), s), ("fc_b", (V,), 0.0),
               ("init_h_w", (H, H), s), ("init_h_b", (H,), 0.0),
               ("init_c_w", (H, H), s), ("init_c_b", (H,), 0.0)])


def make_weights(m: dict, seed: int, device) -> dict:
    """{checkpoint name: float32 tensor on ``device``} from ``seed``."""
    return inputs.uniform_weights(weight_table(m), seed, device)


def program(model: dict, weights: dict, device):
    """The port's DCNet over the flat weights themselves (no copy)."""
    from captionkit_torch.config import ModelConfig
    from captionkit_torch.models import get_model
    from captionkit_torch.params import dcnet_params_from_tensors

    cfg = ModelConfig(**model)
    params = dcnet_params_from_tensors(weights)
    return cfg, get_model(cfg), params


def head(weights) -> tuple:
    return weights["fc_w"], weights["fc_b"]


def reads_features(m: dict) -> bool:
    return False


def encode(w, features, existing, lengths):
    hs, cs = encode_caption(w, existing, lengths)
    T = existing.shape[1]
    return {
        "enc_hs": hs,
        "keys": w.mm(hs, w["attention/w_enc"]),
        "mask": length_mask(lengths, T),
        "h0": w.mm(hs[:, -1], w["init_h_w"]) + w["init_h_b"],
        "c0": w.mm(cs[:, -1], w["init_c_w"]) + w["init_c_b"],
    }


def state0(w, ctx):
    return (ctx["h0"], ctx["c0"])


def step(w, ctx, state, token):
    h, c = state
    emb = w["embedding"][token.long()]
    att_ctx, _ = attend(w, "attention", ctx["keys"], ctx["enc_hs"], h,
                        ctx["mask"])
    gated = torch.sigmoid(w.mm(h, w["gate_w"]) + w["gate_b"]) * att_ctx
    h, c = lstm_step(w, "decoder", torch.cat([emb, gated], -1), h, c)
    return (h, c), w.mm(h, w["fc_w"]) + w["fc_b"]


reference = (encode, state0, step)


def encode_flops(m: dict, t: int) -> int:
    """One image's encode: the caption encoder over ``t`` positions, the
    text keys, the decoder's h0 and c0 (and the visual keys)."""
    E, H, A, F, R = (m["emb_dim"], m["hidden_dim"], m["att_dim"],
                     m["feat_dim"], m["num_regions"])
    total = t * flops.lstm(E, H) + 2 * t * H * A + 2 * 2 * H * H
    if m.get("dcnet_use_visual"):
        total += 2 * R * F * A
    return total


def step_flops(m: dict, t: int) -> int:
    """One decode row's step, to the vocab head's logits."""
    E, H, A, F, R, V = (m["emb_dim"], m["hidden_dim"], m["att_dim"],
                        m["feat_dim"], m["num_regions"], m["vocab_size"])
    query = 2 * H * A
    read = 2 * t * H
    gate = 2 * H * H
    d_in = E + H + (F if m.get("dcnet_use_visual") else 0)
    visual = (2 * H * A + 2 * R * F) if m.get("dcnet_use_visual") else 0
    return query + read + gate + visual + flops.lstm(d_in, H) + 2 * H * V


def caption_flops(m: dict, *, beam: int, steps: int, t: int) -> int:
    """One caption of a ``beam``-wide decode of ``steps`` steps over an
    existing caption of ``t`` positions."""
    return encode_flops(m, t) + steps * beam * step_flops(m, t)
