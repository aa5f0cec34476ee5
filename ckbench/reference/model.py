"""The shared pieces of the plain float32 reference, in plain PyTorch:
the weights, the LSTM step, the caption encoder, additive attention.
Each architecture's encode and decode step are in its module
(``archs/<arch>.py::reference``).

The weights are the flat arrays of the reference checkpoint, by name
(``embedding``, ``encoder/wx`` ...): [in, out] matrices, LSTM gates
ordered i|f|g|o with one bias. No packed, padded or rounded copy is made:
every product is a float32 product of the float32 weights
(``Weights.mm``), and TF32 is off.
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


def lstm_step(w, prefix, x, h, c):
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
        h2, c2 = lstm_step(w, "encoder", emb[:, t], h, c)
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


def length_mask(lengths, T):
    """[B, T]: True at the positions inside each length."""
    return torch.arange(T, device=lengths.device)[None] < lengths[:, None]


def expand(ctx: dict, k: int) -> dict:
    """Every per-image context tensor repeated for k rows an image."""
    return {n: t.repeat_interleave(k, dim=0) for n, t in ctx.items()}
