"""DCNet — LSTM denoising auto-encoder over the existing caption
(``captionkit.models.dcnet``, the serving path).

An LSTM encoder reads the existing caption; an attentive LSTM decoder
writes the edited caption, attending additively over the encoder's hidden
states, with a sigmoid gate on the context vector and a linear head to
the vocab. With ``dcnet_use_visual`` a second attention over the region
features joins the decoder input.

``encode`` runs the encoder once and projects the keys; the decoder's
initial state is a bare Linear of the encoder's last state (no tanh), a
float32 product as in the reference. The plain step asks ``nn.dispatch``
for its decoder LSTM and its attention at the reference's call sites.
``cell_impl="pallas"`` (textual config) has ``prepare_topk`` build the
fused-cell pack and ``_step_hidden`` run ``kernels/megastep.py::
dcnet_fused_step_hidden``; the visual config and ``cell_impl=
"wholestep"`` keep the plain cells, as in the reference. The vocab
head of beam search, its per-batch preparation and its int8 variant are
EditNet's (``base.prepare_head``, ``base.configured_head_topk``).

Training: ``step(train=True)`` applies dropout to the decoder's h;
``forward_seq`` is teacher forcing with the embedding gather, the emb
slice of the decoder's gate product and the vocab head outside the loop,
autograd through the loop by default, or, with ``dcnet_deferred_backward``
and the textual config, ``dcnet_backward.DCNetRecurrentSeq``.
``step_hidden`` (the ensemble's member step) and ``step_attn``
(introspection: the plain step with its attention distributions) are
exported through the ``ModelDef``.
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
from captionkit_torch.models.base import (
    ModelDef,
    apply_dropout_mask,
    compute_dtype,
    configured_head_topk,
    default_generator,
    dropout,
    dropout_mask,
    head_info,
    prepare_head,
)
from captionkit_torch.models.dcnet_backward import dcnet_recurrent_seq
from captionkit_torch.nn.attention import (
    AdditiveAttentionParams,
    project_keys,
)
from captionkit_torch.nn.cells import LSTMParams, lstm_encode, lstm_gates, mm
from captionkit_torch.nn.dispatch import get_attention_fn, get_lstm_cell_fn
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
    # [Vp, Hp] int8, the int8 kernel's K-major copy of head_w (kmajor_head)
    head_wt: Optional[torch.Tensor] = None
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


def _pack_contexts(params: DCNetParams, cfg: ModelConfig) -> dict:
    """The weights of ``_recurrent_contexts`` rounded to the compute
    dtype, from the live parameters (gradients reach them)."""
    dt = compute_dtype(cfg)
    pk = {"gate_w": params.gate_w.to(dt),
          "att_wq": params.attention.w_q.to(dt)}
    if params.vis_attention is not None:
        pk["vis_wq"] = params.vis_attention.w_q.to(dt)
    return pk


def _pack(params: DCNetParams, cfg: ModelConfig) -> dict:
    """The plain step's weights, packed and rounded to the compute dtype,
    from the live parameters."""
    dt = compute_dtype(cfg)
    dec = params.decoder
    return dict(_pack_contexts(params, cfg),
                dec_w=torch.cat([dec.wx, dec.wh], dim=0).to(dt),
                fc_w=params.fc_w.to(dt))


def _packed(params: DCNetParams, cfg: ModelConfig) -> dict:
    """``_pack``, built once per parameter object and compute dtype for
    decoding."""
    dt = compute_dtype(cfg)
    pk = params.cache.get(dt)
    if pk is None:
        pk = _pack(params, cfg)
        params.cache[dt] = pk
    return pk


def encode(params: DCNetParams, cfg: ModelConfig,
           features: Optional[torch.Tensor],  # [B, R, F], visual only
           existing: torch.Tensor,  # [B, T]
           existing_len: torch.Tensor,  # [B]
           ) -> DCNetContext:
    dt = compute_dtype(cfg)
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


def init_state(params: DCNetParams, ctx: DCNetContext,
               max_len: Optional[int] = None) -> DCNetState:
    return DCNetState(h=ctx.h0, c=ctx.c0)


def beam_expand(ctx: DCNetContext, k: int) -> DCNetContext:
    """Repeat only the decoder's initial state per beam; encoder states,
    keys and masks stay per image."""
    return ctx.replace(h0=ctx.h0.repeat_interleave(k, dim=0),
                       c0=ctx.c0.repeat_interleave(k, dim=0))


def _recurrent_contexts(params: DCNetParams, cfg: ModelConfig,
                        ctx: DCNetContext, h: torch.Tensor, pk: dict,
                        use_pallas: bool = False,
                        attn: Optional[dict] = None) -> list[torch.Tensor]:
    """The state-dependent decoder inputs: the gated text context, and the
    visual context when the visual head is on. ``attn`` receives "alpha"
    [B, T] (over the existing caption's positions) and, visual,
    "vis_alpha" [B, R]."""
    dt = compute_dtype(cfg)
    attention = get_attention_fn(use_pallas)
    att_ctx, alpha = attention(
        params.attention, ctx.att_keys, ctx.enc_hs, h, ctx.mask,
        compute_dtype=dt, w_q=pk["att_wq"])
    if attn is not None:
        attn["alpha"] = alpha
    gate = torch.sigmoid(mm(h, pk["gate_w"], dt) + params.gate_b)
    parts = [gate * att_ctx]
    if ctx.features is not None and params.vis_attention is not None:
        vis_ctx, vis_alpha = attention(
            params.vis_attention, ctx.vis_keys, ctx.features, h, None,
            compute_dtype=dt, w_q=pk["vis_wq"])
        if attn is not None:
            attn["vis_alpha"] = vis_alpha
        parts.append(vis_ctx)
    return parts


def _step_hidden(params: DCNetParams, cfg: ModelConfig, ctx: DCNetContext,
                 state: DCNetState, token: torch.Tensor,
                 use_pallas: bool = False,
                 generator: Optional[torch.Generator] = None,
                 train: bool = False, attn: Optional[dict] = None
                 ) -> tuple[DCNetState, torch.Tensor]:
    """One decode step up to the vocab head: (state, h, dropped out when
    ``train``). ``use_pallas`` is handed to ``nn.dispatch`` at the plain
    step's cell call sites; ``train`` takes the plain cells on weights
    packed from the live parameters. ``attn``, a dict, receives the
    step's attention distributions (``step_attn``), from the plain cells:
    the fused pack is not taken then."""
    emb = params.embedding[token]  # [B, E]
    if ctx.cell_pack is not None and not train and attn is None:
        h, c = dcnet_fused_step_hidden(ctx.cell_pack, state.h, state.c, emb)
        return DCNetState(h=h, c=c), h
    pk = _pack(params, cfg) if train else _packed(params, cfg)
    lstm_cell = get_lstm_cell_fn(use_pallas)
    x = torch.cat([emb] + _recurrent_contexts(params, cfg, ctx, state.h, pk,
                                              use_pallas, attn), dim=-1)
    h, c = lstm_cell(params.decoder, x, state.h, state.c,
                     compute_dtype=compute_dtype(cfg), packed=pk["dec_w"])
    return DCNetState(h=h, c=c), dropout(h, cfg.dropout, generator, train)


def step(params: DCNetParams, cfg: ModelConfig, ctx: DCNetContext,
         state: DCNetState, token: torch.Tensor, use_pallas: bool = False,
         generator: Optional[torch.Generator] = None, train: bool = False
         ) -> tuple[DCNetState, torch.Tensor]:
    """One decode step with the full logits [B, V] fp32 (greedy and
    sampling decode). ``use_pallas=True`` takes the cell kernels at the
    dispatch call sites; ``train`` applies dropout with masks from
    ``generator``."""
    new_state, out = _step_hidden(params, cfg, ctx, state, token,
                                  use_pallas, generator, train)
    return new_state, _logits(params, cfg, out, train)


def _logits(params: DCNetParams, cfg: ModelConfig, out: torch.Tensor,
            train: bool = False) -> torch.Tensor:
    """The vocab head on the decoder's h: logits [B, V] fp32."""
    dt = compute_dtype(cfg)
    fc_w = params.fc_w.to(dt) if train else _packed(params, cfg)["fc_w"]
    return mm(out, fc_w, dt) + params.fc_b


def step_attn(params: DCNetParams, cfg: ModelConfig, ctx: DCNetContext,
              state: DCNetState, token: torch.Tensor
              ) -> tuple[DCNetState, torch.Tensor, dict]:
    """Introspection step (``ModelDef.step_attn``): ``step``'s math and
    roundings on the plain cells, plus {"alpha": [B, T] text attention
    over the existing caption's positions} ("vis_alpha" [B, R] too with
    the visual head): which source word the denoiser reads while it
    emits each output word."""
    attn: dict = {}
    new_state, out = _step_hidden(params, cfg, ctx, state, token, attn=attn)
    return new_state, _logits(params, cfg, out), attn


def forward_seq(params: DCNetParams, cfg: ModelConfig, ctx: DCNetContext,
                state0: DCNetState, tokens_in: torch.Tensor,  # [B, T]
                generator: Optional[torch.Generator] = None,
                train: bool = False) -> torch.Tensor:
    """Teacher forcing (``ModelDef.forward_seq``; see
    ``editnet.forward_seq``): logits [B, T, V] fp32. The embedding gather,
    the emb slice of the decoder's gate product (with its bias) and the
    vocab head run outside the loop. Dropout keep masks are drawn step by
    step from ``generator`` (one seeded with 0 when None) in the same
    order on both routes."""
    dt = compute_dtype(cfg)
    E = cfg.emb_dim
    B, T = tokens_in.shape
    H = params.fc_w.shape[0]
    dev = tokens_in.device
    dec = params.decoder
    emb_seq = params.embedding[tokens_in]  # [B, T, E]
    z_x = mm(emb_seq, dec.wx[:E], dt) + dec.b  # [B, T, 4H] fp32
    keep = None
    if train and cfg.dropout > 0.0:
        gen = default_generator(generator, dev)
        keep = [dropout_mask((B, H), cfg.dropout, gen, dev)
                for _ in range(T)]
    if cfg.dcnet_deferred_backward and not cfg.dcnet_use_visual:
        outs = dcnet_recurrent_seq(dt, cfg.dropout, ctx.mask,
                                   None if keep is None else
                                   torch.stack(keep), {
            "w_rec_ctx": dec.wx[E:],
            "w_rec_h": dec.wh,
            "att_wq": params.attention.w_q,
            "att_v": params.attention.v,
            "att_b": params.attention.b,
            "gate_w": params.gate_w,
            "gate_b": params.gate_b,
            "att_keys": ctx.att_keys,
            "enc_hs": ctx.enc_hs,
            "h0": state0.h,
            "c0": state0.c,
            "zx": z_x.transpose(0, 1),
        }).transpose(0, 1)  # [B, T, H]
    else:
        # w_rec rounded once outside the loop, the attention's and the
        # gate's weights inside it, as in the reference's scan.
        w_rec = torch.cat([dec.wx[E:], dec.wh], dim=0).to(dt)
        state, outs = state0, []
        for t in range(T):
            x_rec = torch.cat(_recurrent_contexts(
                params, cfg, ctx, state.h, _pack_contexts(params, cfg))
                + [state.h],
                dim=-1)
            z = z_x[:, t] + mm(x_rec, w_rec, dt)
            h, c = lstm_gates(z, state.c)
            state = DCNetState(h=h, c=c)
            outs.append(h if keep is None
                        else apply_dropout_mask(h, keep[t], cfg.dropout))
        outs = torch.stack(outs, dim=1)
    return mm(outs, params.fc_w, dt) + params.fc_b


def prepare_topk(params: DCNetParams, cfg: ModelConfig, ctx: DCNetContext,
                 k: int) -> DCNetContext:
    """Once per decode batch: the fused-cell pack when ``cell_impl ==
    "pallas"`` and the config is textual (``"wholestep"`` builds none and
    runs the plain cells, as the reference does), and the head (quantized
    under ``head_quant="int8"``, else padded)."""
    return prepare_head(params, cfg, prepare_cells(params, cfg, ctx))


def prepare_cells(params: DCNetParams, cfg: ModelConfig,
                  ctx: DCNetContext) -> DCNetContext:
    """The fused-cell pack of ``prepare_topk`` (``cell_impl == "pallas"``,
    textual config), without the head."""
    if cfg.cell_impl == "pallas" and not cfg.dcnet_use_visual:
        ctx = ctx.replace(
            cell_pack=prepare_dcnet_cell_pack(params, cfg, ctx))
    return ctx


def step_topk(params: DCNetParams, cfg: ModelConfig, ctx: DCNetContext,
              state: DCNetState, token: torch.Tensor, k: int):
    """Decode step with the fused head: (state, top-k logits, their vocab
    ids, log-sum-exp)."""
    new_state, out = _step_hidden(params, cfg, ctx, state, token)
    vals, idx, lse = configured_head_topk(params, cfg, ctx, out, k)
    return new_state, vals, idx, lse


def make_model(cfg: ModelConfig) -> ModelDef:
    return ModelDef(
        name="dcnet",
        init=lambda seed, device="cuda": init(seed, cfg, device),
        encode=lambda params, features, existing, existing_len: encode(
            params, cfg, features, existing, existing_len),
        init_state=init_state,
        step=lambda params, ctx, state, token, generator=None, train=False:
        step(params, cfg, ctx, state, token, generator=generator,
             train=train),
        beam_expand=beam_expand,
        step_topk=(
            (lambda params, ctx, state, token, k: step_topk(
                params, cfg, ctx, state, token, k))
            if cfg.use_fused_head else None),
        prepare_topk=(
            (lambda params, ctx, k: prepare_topk(params, cfg, ctx, k))
            if cfg.use_fused_head else None),
        head_info=head_info(cfg),
        forward_seq=(
            lambda params, ctx, state0, tokens_in, generator=None,
            train=False: forward_seq(params, cfg, ctx, state0, tokens_in,
                                     generator, train)),
        step_hidden=lambda params, ctx, state, token: _step_hidden(
            params, cfg, ctx, state, token),
        prepare_cells=lambda params, ctx: prepare_cells(params, cfg, ctx),
        step_attn=lambda params, ctx, state, token: step_attn(
            params, cfg, ctx, state, token),
    )
