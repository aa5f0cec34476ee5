"""DCNet — LSTM denoising auto-encoder over the existing caption
(``captionkit.models.dcnet``, the serving path).

An LSTM encoder reads the existing caption; an attentive LSTM decoder
writes the edited caption, attending additively over the encoder's hidden
states, with a sigmoid gate on the context vector and a linear head to
the vocab. With ``dcnet_use_visual`` a second attention over the region
features joins the decoder input.

``encode`` runs the encoder once and projects the keys; the decoder's
initial state is a bare Linear of the encoder's last state (no tanh), a
float32 product as in the reference. ``cell_impl="pallas"`` (textual
config) has ``prepare_topk`` build the fused-cell pack and
``_step_hidden`` run ``kernels/megastep.py::dcnet_fused_step_hidden``;
the visual config keeps the plain cells, as in the reference. The vocab
head of beam search, its per-batch preparation and its int8 variant are
EditNet's (``editnet.prepare_head``, ``editnet._head_topk``).

Not ported yet: ``forward_seq`` and training dropout (training), and
``step_attn`` (introspection).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch

from captionkit_torch.config import ModelConfig
from captionkit_torch.device import resolve_device
from captionkit_torch.kernels.megastep import (
    DCNetCellPack,
    dcnet_fused_step_hidden,
    prepare_dcnet_cell_pack,
)
from captionkit_torch.models.base import HeadInfo, ModelDef
from captionkit_torch.models.editnet import (
    _cdt,
    _head_topk,
    check_ported_options,
    prepare_head,
)
from captionkit_torch.nn.attention import (
    AdditiveAttentionParams,
    additive_attention,
    project_keys,
)
from captionkit_torch.nn.cells import LSTMParams, lstm_encode, lstm_gates, mm
from captionkit_torch.nn.masking import length_mask


@dataclass
class DCNetParams:
    embedding: torch.Tensor  # [V, E]
    encoder: LSTMParams  # E -> H
    attention: AdditiveAttentionParams  # keys: encoder H, query: decoder H
    gate_w: torch.Tensor  # [H, H] context gate: sigmoid(h W + b)
    gate_b: torch.Tensor  # [H]
    decoder: LSTMParams  # (E + H [+ F]) -> H, wx rows packed [E | H | F]
    fc_w: torch.Tensor  # [H, V]
    fc_b: torch.Tensor  # [V]
    init_h_w: torch.Tensor  # [H, H] decoder h0 from the encoder's last h
    init_h_b: torch.Tensor  # [H]
    init_c_w: torch.Tensor  # [H, H] decoder c0 from the encoder's last c
    init_c_b: torch.Tensor  # [H]
    vis_attention: Optional[AdditiveAttentionParams] = None  # visual only
    # Packed step weights per compute dtype; see editnet.EditNetParams.
    cache: dict = field(default_factory=dict, repr=False, compare=False)


@dataclass
class DCNetContext:
    enc_hs: torch.Tensor  # [B, T, H] encoder hidden states (values)
    att_keys: torch.Tensor  # [B, T, A] projected keys
    mask: torch.Tensor  # [B, T] bool
    h0: torch.Tensor  # [B, H] decoder initial state (per beam after
    c0: torch.Tensor  # [B, H]  beam_expand)
    features: Optional[torch.Tensor] = None  # [B, R, F] visual only
    vis_keys: Optional[torch.Tensor] = None  # [B, R, A]
    head_w: Optional[torch.Tensor] = None  # [H, Vp] compute dtype or int8
    head_b: Optional[torch.Tensor] = None  # [Vp] fp32, padding -1e30
    head_scale: Optional[torch.Tensor] = None  # [Vp] fp32, int8 head only
    # Fused decode-cell pack, built by prepare_topk for cell_impl="pallas".
    cell_pack: Optional[DCNetCellPack] = None

    def replace(self, **kw) -> "DCNetContext":
        return dataclasses.replace(self, **kw)


@dataclass
class DCNetState:
    h: torch.Tensor  # [B, H]
    c: torch.Tensor


def init(seed: int, cfg: ModelConfig,
         device: "str | torch.device" = "cuda") -> DCNetParams:
    """Random parameters from ``seed`` on ``device`` (the card unless the
    caller names the CPU; raises without CUDA), with the reference's
    distributions (uniform, torch-style scales; zero attention, gate, init
    and head biases). The numbers are not JAX's: load a checkpoint for
    parity."""
    device = resolve_device(device)
    E, H, A, V, F = (cfg.emb_dim, cfg.hidden_dim, cfg.att_dim,
                     cfg.vocab_size, cfg.feat_dim)
    g = torch.Generator().manual_seed(seed)
    s = H ** -0.5

    def u(shape, scale):
        return ((torch.rand(shape, generator=g) * 2.0 - 1.0) * scale).to(
            device)

    def zeros(shape):
        return torch.zeros(shape, device=device)

    def lstm(in_dim):
        return LSTMParams(wx=u((in_dim, 4 * H), s), wh=u((H, 4 * H), s),
                          b=u((4 * H,), s))

    def attention(enc_dim):
        return AdditiveAttentionParams(
            w_enc=u((enc_dim, A), enc_dim ** -0.5), w_q=u((H, A), s),
            v=u((A,), A ** -0.5), b=zeros((A,)))

    visual = cfg.dcnet_use_visual
    return DCNetParams(
        embedding=u((V, E), 0.1),
        encoder=lstm(E),
        attention=attention(H),
        gate_w=u((H, H), s),
        gate_b=zeros((H,)),
        decoder=lstm(E + H + (F if visual else 0)),
        fc_w=u((H, V), s),
        fc_b=zeros((V,)),
        init_h_w=u((H, H), s),
        init_h_b=zeros((H,)),
        init_c_w=u((H, H), s),
        init_c_b=zeros((H,)),
        vis_attention=attention(F) if visual else None,
    )


def _packed(params: DCNetParams, cfg: ModelConfig) -> dict:
    """The plain step's weights, packed and rounded once per parameter
    object and compute dtype."""
    dt = _cdt(cfg)
    pk = params.cache.get(dt)
    if pk is None:
        dec = params.decoder
        pk = {
            "dec_w": torch.cat([dec.wx, dec.wh], dim=0).to(dt),
            "gate_w": params.gate_w.to(dt),
            "att_wq": params.attention.w_q.to(dt),
            "fc_w": params.fc_w.to(dt),
        }
        if params.vis_attention is not None:
            pk["vis_wq"] = params.vis_attention.w_q.to(dt)
        params.cache[dt] = pk
    return pk


def encode(params: DCNetParams, cfg: ModelConfig,
           features: Optional[torch.Tensor],  # [B, R, F], visual only
           existing: torch.Tensor,  # [B, T]
           existing_len: torch.Tensor,  # [B]
           ) -> DCNetContext:
    dt = _cdt(cfg)
    emb = params.embedding[existing]
    hs, cs = lstm_encode(params.encoder, emb, existing_len, compute_dtype=dt)
    keys = project_keys(params.attention, hs, compute_dtype=dt).to(dt)
    # A bare Linear of the last (frozen-at-length) encoder state, in
    # float32 (TF32 is off: see captionkit_torch/__init__.py).
    h0 = hs[:, -1, :] @ params.init_h_w + params.init_h_b
    c0 = cs[:, -1, :] @ params.init_c_w + params.init_c_b
    feats = vis_keys = None
    if cfg.dcnet_use_visual and params.vis_attention is not None:
        feats = features.to(dt)
        vis_keys = project_keys(params.vis_attention, features,
                                compute_dtype=dt).to(dt)
    return DCNetContext(
        enc_hs=hs.to(dt), att_keys=keys,
        mask=length_mask(existing_len, existing.shape[1]), h0=h0, c0=c0,
        features=feats, vis_keys=vis_keys)


def init_state(params: DCNetParams, ctx: DCNetContext) -> DCNetState:
    return DCNetState(h=ctx.h0, c=ctx.c0)


def beam_expand(ctx: DCNetContext, k: int) -> DCNetContext:
    """Repeat only the decoder's initial state per beam; encoder states,
    keys and masks stay per image."""
    return ctx.replace(h0=ctx.h0.repeat_interleave(k, dim=0),
                       c0=ctx.c0.repeat_interleave(k, dim=0))


def _recurrent_contexts(params: DCNetParams, cfg: ModelConfig,
                        ctx: DCNetContext,
                        h: torch.Tensor) -> list[torch.Tensor]:
    """The state-dependent decoder inputs: the gated text context, and the
    visual context when the visual head is on."""
    dt = _cdt(cfg)
    pk = _packed(params, cfg)
    att_ctx, _ = additive_attention(
        params.attention, ctx.att_keys, ctx.enc_hs, h, ctx.mask,
        compute_dtype=dt, w_q=pk["att_wq"])
    gate = torch.sigmoid(mm(h, pk["gate_w"], dt) + params.gate_b)
    parts = [gate * att_ctx]
    if ctx.features is not None and params.vis_attention is not None:
        vis_ctx, _ = additive_attention(
            params.vis_attention, ctx.vis_keys, ctx.features, h, None,
            compute_dtype=dt, w_q=pk["vis_wq"])
        parts.append(vis_ctx)
    return parts


def _step_hidden(params: DCNetParams, cfg: ModelConfig, ctx: DCNetContext,
                 state: DCNetState,
                 token: torch.Tensor) -> tuple[DCNetState, torch.Tensor]:
    """One decode step up to the vocab head: (state, h)."""
    emb = params.embedding[token]  # [B, E]
    if ctx.cell_pack is not None:
        h, c = dcnet_fused_step_hidden(ctx.cell_pack, state.h, state.c, emb)
        return DCNetState(h=h, c=c), h
    dt = _cdt(cfg)
    x = torch.cat([emb] + _recurrent_contexts(params, cfg, ctx, state.h)
                  + [state.h], dim=-1)
    z = mm(x, _packed(params, cfg)["dec_w"], dt) + params.decoder.b
    h, c = lstm_gates(z, state.c)
    return DCNetState(h=h, c=c), h


def step(params: DCNetParams, cfg: ModelConfig, ctx: DCNetContext,
         state: DCNetState, token: torch.Tensor
         ) -> tuple[DCNetState, torch.Tensor]:
    """One decode step with the full logits [B, V] fp32."""
    new_state, out = _step_hidden(params, cfg, ctx, state, token)
    logits = mm(out, _packed(params, cfg)["fc_w"], _cdt(cfg)) + params.fc_b
    return new_state, logits


def prepare_topk(params: DCNetParams, cfg: ModelConfig, ctx: DCNetContext,
                 k: int) -> DCNetContext:
    """Once per decode batch: the fused-cell pack when ``cell_impl ==
    "pallas"`` and the config is textual, and the head (quantized under
    ``head_quant="int8"``, else padded)."""
    if cfg.cell_impl == "pallas" and not cfg.dcnet_use_visual:
        ctx = ctx.replace(
            cell_pack=prepare_dcnet_cell_pack(params, cfg, ctx))
    return prepare_head(params, cfg, ctx)


def step_topk(params: DCNetParams, cfg: ModelConfig, ctx: DCNetContext,
              state: DCNetState, token: torch.Tensor, k: int):
    """Decode step with the fused head: (state, top-k logits, their vocab
    ids, log-sum-exp)."""
    new_state, out = _step_hidden(params, cfg, ctx, state, token)
    vals, idx, lse = _head_topk(params, cfg, ctx, out, k)
    return new_state, vals, idx, lse


def make_model(cfg: ModelConfig) -> ModelDef:
    check_ported_options(cfg)
    return ModelDef(
        name="dcnet",
        init=lambda seed, device="cuda": init(seed, cfg, device),
        encode=lambda params, features, existing, existing_len: encode(
            params, cfg, features, existing, existing_len),
        init_state=init_state,
        step=lambda params, ctx, state, token: step(
            params, cfg, ctx, state, token),
        beam_expand=beam_expand,
        step_topk=(
            (lambda params, ctx, state, token, k: step_topk(
                params, cfg, ctx, state, token, k))
            if cfg.use_fused_head else None),
        prepare_topk=(
            (lambda params, ctx, k: prepare_topk(params, cfg, ctx, k))
            if cfg.use_fused_head else None),
        head_info=HeadInfo(
            get_wb=lambda p: (p.fc_w, p.fc_b),
            impl=cfg.head_impl,
            quant=cfg.head_quant,
            compute_dtype=_cdt(cfg),
            extract=cfg.head_extract,
        ),
    )
