"""Model FLOPs of a beam decode, from the configuration's widths.

A caption costs its encode (once per image) plus ``steps`` decode steps
of ``beam`` rows each: every row of the beam runs the whole step, live or
not, as the batched beam search does. Counted are the products (2 m n k
for an [m, k] x [k, n] product) and the attention reads (weights times
values); the score arithmetic of additive attention (an add, a tanh, a
multiply-add per term) and the gates' elementwise work are not products
and are left out, as a model FLOP count leaves them out.
"""

from __future__ import annotations


def _lstm(d_in: int, h: int) -> int:
    return 2 * (d_in + h) * 4 * h


def encode_flops(arch: str, m: dict, t: int) -> int:
    """One image's encode: the caption encoder over ``t`` positions and
    the step-invariant projections."""
    E, H, A, F, R = (m["emb_dim"], m["hidden_dim"], m["att_dim"],
                     m["feat_dim"], m["num_regions"])
    flops = t * _lstm(E, H) + 2 * t * H * A  # encoder, text keys
    if arch == "editnet":
        flops += 2 * R * F * A + 2 * F * 4 * H  # visual keys, v_mean term
    else:
        flops += 2 * 2 * H * H  # the decoder's h0 and c0
        if m.get("dcnet_use_visual"):
            flops += 2 * R * F * A
    return flops


def step_flops(arch: str, m: dict, t: int) -> int:
    """One decode row's step, to the vocab head's logits."""
    E, H, A, F, R, V = (m["emb_dim"], m["hidden_dim"], m["att_dim"],
                        m["feat_dim"], m["num_regions"], m["vocab_size"])
    head = 2 * H * V
    if arch == "editnet":
        att_lstm = _lstm(E + H, H)  # [emb | h_lang] and h_att; v_mean hoisted
        queries = 2 * H * 2 * A  # visual and SCMA queries
        reads = 2 * R * F + 2 * t * H  # alpha -> v_hat, beta -> c*
        gate = 2 * H * F
        lang = _lstm(F + H, H) + 2 * (F + 3 * H) * H  # Copy-LSTM + copy gate
        return att_lstm + queries + reads + gate + lang + head
    query = 2 * H * A
    read = 2 * t * H
    gate = 2 * H * H
    d_in = E + H + (F if m.get("dcnet_use_visual") else 0)
    visual = (2 * H * A + 2 * R * F) if m.get("dcnet_use_visual") else 0
    return query + read + gate + visual + _lstm(d_in, H) + head


def caption_flops(arch: str, m: dict, *, beam: int, steps: int,
                  t: int) -> int:
    """One caption of a ``beam``-wide decode of ``steps`` steps over an
    existing caption of ``t`` positions."""
    return encode_flops(arch, m, t) + steps * beam * step_flops(arch, m, t)
