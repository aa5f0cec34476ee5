"""Torch twin models of DCNet and EditNet (``captionkit.convert.torch_ref``,
copied: the port imports nothing of the JAX package).

They follow the released PyTorch code's conventions: [out, in] Linear
weights, LSTM weight_ih/weight_hh with separate bias_ih/bias_hh in (i, f,
g, o) gate order, tutorial-family module names. The converter
(``torch_import.py``) maps these names to the port's parameters; the
parity gate (``gate.py``) runs a twin loaded with a checkpoint's weights
beside the converted model and requires identical greedy captions.

``beam_search_slow`` is a batch=1 Python-loop beam search, the
reference-style decode. The twins are built on the CPU (the same random
weights as the reference's twins for one seed) and run on the device of
their inputs: ``device=`` moves one there after it is built.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class ManualLSTMCell(nn.Module):
    """LSTM cell with torch parameter layout, explicit math (the port's
    ``nn.cells.lstm_cell`` in float32)."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        s = 1.0 / math.sqrt(hidden)

        def u(*shape):
            return nn.Parameter(torch.empty(*shape).uniform_(-s, s))

        self.weight_ih = u(4 * hidden, in_dim)
        self.weight_hh = u(4 * hidden, hidden)
        self.bias_ih = u(4 * hidden)
        self.bias_hh = u(4 * hidden)
        self.hidden = hidden

    def forward(self, x, h, c):
        z = (x @ self.weight_ih.T + self.bias_ih
             + h @ self.weight_hh.T + self.bias_hh)
        i, f, g, o = z.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return h_new, c_new


class Attention(nn.Module):
    """Additive attention, tutorial naming (encoder_att/decoder_att/full_att)."""

    def __init__(self, enc_dim: int, q_dim: int, att_dim: int):
        super().__init__()
        self.encoder_att = nn.Linear(enc_dim, att_dim)
        self.decoder_att = nn.Linear(q_dim, att_dim)
        self.full_att = nn.Linear(att_dim, 1)

    def forward(self, enc, query, mask=None):
        # enc [B, N, E]; query [B, Q]; mask [B, N] bool
        e = torch.tanh(self.encoder_att(enc)
                       + self.decoder_att(query).unsqueeze(1))
        scores = self.full_att(e).squeeze(-1)  # [B, N]
        if mask is not None:
            scores = scores.masked_fill(~mask, -1e9)
        alpha = F.softmax(scores, dim=-1)
        ctx = (alpha.unsqueeze(-1) * enc).sum(1)
        return ctx, alpha


def _encode_frozen(cell: ManualLSTMCell, emb, lengths):
    """Run an LSTM over padded steps, freezing state at each row's length
    (pack_padded semantics; twin of ``nn.cells.lstm_encode``)."""
    B, T, _ = emb.shape
    h = emb.new_zeros(B, cell.hidden)
    c = emb.new_zeros(B, cell.hidden)
    hs, cs = [], []
    for t in range(T):
        h_new, c_new = cell(emb[:, t], h, c)
        keep = (t < lengths).float().unsqueeze(-1)
        h = keep * h_new + (1 - keep) * h
        c = keep * c_new + (1 - keep) * c
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, 1), torch.stack(cs, 1)


class TorchDCNet(nn.Module):
    """Twin of ``models/dcnet.py`` (text-only by default; the
    ``dcnet_use_visual`` variant adds top-down visual attention whose
    context joins the decoder input)."""

    def __init__(self, vocab: int, emb: int = 1024, hidden: int = 1024,
                 att: int = 512, *, use_visual: bool = False,
                 feat: int = 2048, device=None):
        super().__init__()
        self.embedding = nn.Embedding(vocab, emb)
        self.encoder = ManualLSTMCell(emb, hidden)
        self.attention = Attention(hidden, hidden, att)
        self.f_beta = nn.Linear(hidden, hidden)
        self.use_visual = use_visual
        dec_in = emb + hidden
        if use_visual:
            self.vis_attention = Attention(feat, hidden, att)
            dec_in += feat
        self.decode_step = ManualLSTMCell(dec_in, hidden)
        self.init_h = nn.Linear(hidden, hidden)
        self.init_c = nn.Linear(hidden, hidden)
        self.fc = nn.Linear(hidden, vocab)
        if device is not None:
            self.to(device)

    def encode(self, existing, lengths, features=None):
        emb = self.embedding(existing)
        hs, cs = _encode_frozen(self.encoder, emb, lengths)
        T = existing.shape[1]
        mask = torch.arange(T, device=lengths.device)[None, :] \
            < lengths[:, None]
        h0 = self.init_h(hs[:, -1])
        c0 = self.init_c(cs[:, -1])
        return {"enc_hs": hs, "mask": mask, "h0": h0, "c0": c0,
                **({"features": features} if features is not None else {})}

    def step(self, ctx, h, c, token):
        emb = self.embedding(token)
        att_ctx, _ = self.attention(ctx["enc_hs"], h, ctx["mask"])
        att_ctx = torch.sigmoid(self.f_beta(h)) * att_ctx
        parts = [emb, att_ctx]
        if self.use_visual:
            vis_ctx, _ = self.vis_attention(ctx["features"], h)
            parts.append(vis_ctx)
        h, c = self.decode_step(torch.cat(parts, -1), h, c)
        return h, c, self.fc(h)

    def init_state(self, ctx):
        return ctx["h0"], ctx["c0"]


class CopyLSTMCell(nn.Module):
    """Twin of ``nn.cells.copy_lstm_cell`` with torch layout."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.base = ManualLSTMCell(in_dim, hidden)
        s = 1.0 / math.sqrt(hidden)

        def u(*shape):
            return nn.Parameter(torch.empty(*shape).uniform_(-s, s))

        self.weight_rx = u(hidden, in_dim)
        self.weight_rh = u(hidden, hidden)
        self.weight_rc = u(hidden, hidden)
        self.bias_r = u(hidden)

    def forward(self, x, h, c, c_star):
        z = (x @ self.base.weight_ih.T + self.base.bias_ih
             + h @ self.base.weight_hh.T + self.base.bias_hh)
        i, f, g, o = z.chunk(4, dim=-1)
        c_gen = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        r = torch.sigmoid(x @ self.weight_rx.T + h @ self.weight_rh.T
                          + c_star @ self.weight_rc.T + self.bias_r)
        c_new = r * c_star + (1 - r) * c_gen
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return h_new, c_new


class TorchEditNet(nn.Module):
    """Twin of ``models/editnet.py``."""

    def __init__(self, vocab: int, emb: int = 1024, hidden: int = 1024,
                 att: int = 512, feat: int = 2048,
                 scma_mode: str = "soft", device=None):
        super().__init__()
        # Selection semantics are NOT recorded in a state dict; fitting a
        # real checkpoint may require flipping this to "hard", mirrored by
        # ModelConfig.scma_select.
        self.scma_mode = scma_mode
        self.embedding = nn.Embedding(vocab, emb)
        self.encoder = ManualLSTMCell(emb, hidden)
        self.att_lstm = ManualLSTMCell(emb + feat + hidden, hidden)
        self.vis_attention = Attention(feat, hidden, att)
        self.f_beta = nn.Linear(hidden, feat)
        self.scma = Attention(hidden, hidden, att)
        self.lang_lstm = CopyLSTMCell(feat + hidden, hidden)
        self.fc = nn.Linear(hidden, vocab)
        if device is not None:
            self.to(device)

    def encode(self, features, existing, lengths):
        emb = self.embedding(existing)
        hs, cs = _encode_frozen(self.encoder, emb, lengths)
        T = existing.shape[1]
        mask = torch.arange(T, device=lengths.device)[None, :] \
            < lengths[:, None]
        return {
            "features": features, "v_mean": features.mean(1),
            "enc_hs": hs, "enc_cs": cs, "mask": mask,
        }

    def init_state(self, ctx):
        B = ctx["features"].shape[0]
        H = self.fc.in_features
        z = ctx["features"].new_zeros(B, H)
        return z, z.clone(), z.clone(), z.clone()

    def step(self, ctx, h_att, c_att, h_lang, c_lang, token):
        emb = self.embedding(token)
        x_att = torch.cat([emb, ctx["v_mean"], h_lang], -1)
        h_att, c_att = self.att_lstm(x_att, h_att, c_att)
        v_hat, _ = self.vis_attention(ctx["features"], h_att)
        v_hat = torch.sigmoid(self.f_beta(h_att)) * v_hat
        _, beta = self.scma(ctx["enc_hs"], h_att, ctx["mask"])
        if self.scma_mode == "hard":
            idx = beta.argmax(-1)
            c_star = ctx["enc_cs"][torch.arange(idx.shape[0], device=idx.device),
                                  idx]
        else:
            c_star = (beta.unsqueeze(-1) * ctx["enc_cs"]).sum(1)
        h_lang, c_lang = self.lang_lstm(
            torch.cat([v_hat, h_att], -1), h_lang, c_lang, c_star
        )
        return h_att, c_att, h_lang, c_lang, self.fc(h_lang)


# ---------------------------------------------------------------------------
# Reference-style batch=1 Python-loop beam search (the CPU denominator).
# ---------------------------------------------------------------------------


@torch.no_grad()
def beam_search_slow(
    model, features, existing, length, *, beam_size: int, start_id: int,
    end_id: int, max_len: int = 22,
) -> list[int]:
    """One image at a time, sgrvinod-style: k beams as a size-k batch,
    Python loop per step, shrink k as hypotheses complete. features may
    be None for DCNet. Runs on the device of ``existing``."""
    k = beam_size
    if features is not None:
        ctx = model.encode(features.expand(k, -1, -1), existing.expand(k, -1),
                           length.expand(k))
        state = list(model.init_state(ctx))
    else:
        ctx = model.encode(existing.expand(k, -1), length.expand(k))
        state = list(model.init_state(ctx))
    dev = existing.device
    seqs = torch.full((k, 1), start_id, dtype=torch.long, device=dev)
    scores = torch.zeros(k, device=dev)
    scores[1:] = -1e9
    complete, complete_scores = [], []
    tok = seqs[:, -1]
    for _ in range(max_len):
        out = model.step(ctx, *state, tok)
        state, logits = list(out[:-1]), out[-1]
        logp = F.log_softmax(logits, dim=-1)
        total = scores.unsqueeze(1) + logp  # [k, V]
        V = total.shape[1]
        top_scores, top_idx = total.view(-1).topk(k)
        parent = top_idx // V
        tok = (top_idx % V).long()
        seqs = torch.cat([seqs[parent], tok.unsqueeze(1)], 1)
        state = [s[parent] for s in state]
        ctx = {key: val[parent] for key, val in ctx.items()}
        scores = top_scores
        is_end = tok == end_id
        for j in torch.where(is_end)[0].tolist():
            complete.append(seqs[j, 1:].tolist())
            complete_scores.append(float(scores[j]))
            scores[j] = -1e9  # retire the slot
        if len(complete) >= beam_size:
            break
    if complete:
        return complete[int(torch.tensor(complete_scores).argmax())]
    return seqs[int(scores.argmax()), 1:].tolist()
