"""EditNet — visually grounded caption editor with SCMA + Copy-LSTM
(``captionkit.models.editnet``, the serving path).

1. An LSTM encoder reads the existing caption and keeps its hidden states
   {h_i} and cell states {c_i}; the cell states are SCMA's copy pool.
2. A top-down two-LSTM decoder over the region features:
   att-LSTM on [w_emb ; v_mean ; h_lang] -> h_att; visual attention -> v_hat
   (gated); SCMA scores {h_i} with h_att and selects from {c_i} -> c*;
   the Copy-LSTM on [v_hat ; h_att] blends c* into its cell; fc(h_lang)
   gives the vocab logits.

``encode`` runs the caption encoder once, projects both key sets, and
hoists the step-invariant v_mean slice of the att-LSTM product into
``att_zv``. Context tensors are stored in the compute dtype, rounded where
the reference rounds them. The step's products run on operands rounded to
the compute dtype with float32 results (``nn.cells.mm``); the packed,
rounded weights are built once per parameter object (``_packed``).

``cell_impl="xla"`` steps through plain PyTorch cells. ``cell_impl=
"pallas"`` (soft SCMA) has ``prepare_topk`` build the fused-cell pack and
``_step_hidden`` run ``kernels/megastep.py::fused_step_hidden``; hard SCMA
keeps the plain cells, as in the reference. The vocab head of beam search
is a CUDA kernel of ``kernels/head.py``: the float head with either
extraction (``head_extract``), or, with ``head_quant="int8"``, the int8
head over the fp32 hidden state and the head quantized once per batch.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch

from captionkit_torch.config import ModelConfig
from captionkit_torch.device import resolve_device
from captionkit_torch.kernels.head import (
    fused_head_topk,
    fused_head_topk_int8,
    prepad_head,
    quantize_head,
    reference_head_topk,
    reference_head_topk_int8,
)
from captionkit_torch.kernels.megastep import (
    CellPack,
    fused_step_hidden,
    prepare_cell_pack,
)
from captionkit_torch.models.base import HeadInfo, ModelDef
from captionkit_torch.nn.attention import (
    AdditiveAttentionParams,
    additive_attention,
    project_keys,
    scma_select,
)
from captionkit_torch.nn.cells import (
    CopyLSTMParams,
    LSTMParams,
    copy_lstm_cell,
    lstm_encode,
    lstm_gates,
    mm,
    pack_copy_lstm,
)
from captionkit_torch.nn.masking import length_mask


@dataclass
class EditNetParams:
    embedding: torch.Tensor  # [V, E]
    encoder: LSTMParams  # caption encoder: E -> H
    att_lstm: LSTMParams  # [E + F + H] -> H (wx rows packed [E | F | H])
    vis_attention: AdditiveAttentionParams  # keys from F, query H
    vis_gate_w: torch.Tensor  # [H, F]
    vis_gate_b: torch.Tensor  # [F]
    scma: AdditiveAttentionParams  # keys from encoder H, query H
    lang_lstm: CopyLSTMParams  # [F + H] -> H, with copy gate
    fc_w: torch.Tensor  # [H, V]
    fc_b: torch.Tensor  # [V]
    # Packed step weights per compute dtype (``_packed``). Parameters are
    # read-only while they serve; clear this after changing them in place.
    cache: dict = field(default_factory=dict, repr=False, compare=False)


@dataclass
class EditNetContext:
    features: torch.Tensor  # [B, R, F] compute dtype
    vis_keys: torch.Tensor  # [B, R, A]
    v_mean: torch.Tensor  # [B, F] (per beam after beam_expand)
    att_zv: torch.Tensor  # [B, 4H] fp32, hoisted v_mean . Wx_v
    enc_hs: torch.Tensor  # [B, T, H]
    enc_cs: torch.Tensor  # [B, T, H] SCMA copy pool
    scma_keys: torch.Tensor  # [B, T, A]
    mask: torch.Tensor  # [B, T] bool
    head_w: Optional[torch.Tensor] = None  # [H, Vp] compute dtype or int8
    head_b: Optional[torch.Tensor] = None  # [Vp] fp32, padding -1e30
    head_scale: Optional[torch.Tensor] = None  # [Vp] fp32, int8 head only
    # Fused decode-cell pack, built by prepare_topk for cell_impl="pallas".
    cell_pack: Optional[CellPack] = None

    def replace(self, **kw) -> "EditNetContext":
        return dataclasses.replace(self, **kw)


@dataclass
class EditNetState:
    h_att: torch.Tensor  # [B, H]
    c_att: torch.Tensor
    h_lang: torch.Tensor
    c_lang: torch.Tensor


def _cdt(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else \
        torch.float32


def init(seed: int, cfg: ModelConfig,
         device: "str | torch.device" = "cuda") -> EditNetParams:
    """Random parameters from ``seed`` on ``device`` (the card unless the
    caller names the CPU; raises without CUDA), with the reference's
    distributions (uniform, torch-style scales; zero attention and gate
    biases). The numbers are not JAX's: load a checkpoint for parity."""
    device = resolve_device(device)
    E, H, A, V, F = (cfg.emb_dim, cfg.hidden_dim, cfg.att_dim,
                     cfg.vocab_size, cfg.feat_dim)
    g = torch.Generator().manual_seed(seed)

    def u(shape, scale):
        return ((torch.rand(shape, generator=g) * 2.0 - 1.0) * scale).to(
            device)

    def zeros(shape):
        return torch.zeros(shape, device=device)

    def lstm(in_dim):
        s = H ** -0.5
        return LSTMParams(wx=u((in_dim, 4 * H), s), wh=u((H, 4 * H), s),
                          b=u((4 * H,), s))

    def attention(enc_dim, q_dim):
        return AdditiveAttentionParams(
            w_enc=u((enc_dim, A), enc_dim ** -0.5),
            w_q=u((q_dim, A), q_dim ** -0.5), v=u((A,), A ** -0.5),
            b=zeros((A,)))

    embedding = u((V, E), 0.1)
    encoder = lstm(E)
    att_lstm = lstm(E + F + H)
    vis_attention = attention(F, H)
    vis_gate_w = u((H, F), H ** -0.5)
    scma = attention(H, H)
    s = H ** -0.5
    lang_lstm = CopyLSTMParams(
        base=lstm(F + H), wrx=u((F + H, H), s), wrh=u((H, H), s),
        wrc=u((H, H), s), br=u((H,), s))
    return EditNetParams(
        embedding=embedding, encoder=encoder, att_lstm=att_lstm,
        vis_attention=vis_attention, vis_gate_w=vis_gate_w,
        vis_gate_b=zeros((F,)), scma=scma, lang_lstm=lang_lstm,
        fc_w=u((H, V), H ** -0.5), fc_b=zeros((V,)))


def _packed(params: EditNetParams, cfg: ModelConfig) -> dict:
    """The step's weights packed and rounded to the compute dtype, built
    once per parameter object and dtype (the reference's loop-invariant
    concats, which XLA hoists out of its decode loop)."""
    dt = _cdt(cfg)
    pk = params.cache.get(dt)
    if pk is None:
        E, F = cfg.emb_dim, cfg.feat_dim
        wx = params.att_lstm.wx
        w_att = torch.cat([wx[:E], wx[E + F:], params.att_lstm.wh], dim=0)
        pk = {
            "w_att": w_att.to(dt),
            "gate_w": params.vis_gate_w.to(dt),
            "vis_wq": params.vis_attention.w_q.to(dt),
            "scma_wq": params.scma.w_q.to(dt),
            "lang": pack_copy_lstm(params.lang_lstm, dt),
            "fc_w": params.fc_w.to(dt),
        }
        params.cache[dt] = pk
    return pk


def encode(params: EditNetParams, cfg: ModelConfig,
           features: torch.Tensor,  # [B, R, F]
           existing: torch.Tensor,  # [B, T]
           existing_len: torch.Tensor,  # [B]
           ) -> EditNetContext:
    dt = _cdt(cfg)
    E, F = cfg.emb_dim, cfg.feat_dim
    emb = params.embedding[existing]
    hs, cs = lstm_encode(params.encoder, emb, existing_len, compute_dtype=dt)
    # jnp.mean keeps the input dtype (it sums in fp32).
    v_mean = features.float().mean(dim=1).to(features.dtype)
    att_zv = mm(v_mean, params.att_lstm.wx[E:E + F], dt)
    return EditNetContext(
        features=features.to(dt),
        vis_keys=project_keys(params.vis_attention, features,
                              compute_dtype=dt).to(dt),
        v_mean=v_mean.to(dt),
        att_zv=att_zv,
        enc_hs=hs.to(dt),
        enc_cs=cs.to(dt),
        scma_keys=project_keys(params.scma, hs, compute_dtype=dt).to(dt),
        mask=length_mask(existing_len, existing.shape[1]),
    )


def init_state(params: EditNetParams, ctx: EditNetContext) -> EditNetState:
    # Sized from v_mean: after beam_expand it is the per-beam leaf.
    B = ctx.v_mean.shape[0]
    H = params.fc_w.shape[0]
    z = torch.zeros((B, H), dtype=torch.float32, device=ctx.v_mean.device)
    return EditNetState(h_att=z, c_att=z.clone(), h_lang=z.clone(),
                        c_lang=z.clone())


def beam_expand(ctx: EditNetContext, k: int) -> EditNetContext:
    """Repeat only v_mean and att_zv per beam (rows b*K .. b*K+K-1); the
    attention keys, values and masks stay per image."""
    return ctx.replace(v_mean=ctx.v_mean.repeat_interleave(k, dim=0),
                       att_zv=ctx.att_zv.repeat_interleave(k, dim=0))


def _step_hidden(params: EditNetParams, cfg: ModelConfig,
                 ctx: EditNetContext, state: EditNetState,
                 token: torch.Tensor) -> tuple[EditNetState, torch.Tensor]:
    """One decode step up to the vocab head: (state, h_lang)."""
    emb = params.embedding[token]  # [B, E]
    if ctx.cell_pack is not None:
        h_att, c_att, h_lang, c_lang = fused_step_hidden(
            ctx.cell_pack, state.h_att, state.c_att, state.h_lang,
            state.c_lang, emb)
        return EditNetState(h_att=h_att, c_att=c_att, h_lang=h_lang,
                            c_lang=c_lang), h_lang
    dt = _cdt(cfg)
    pk = _packed(params, cfg)
    # 1. Attention LSTM over the step-varying inputs plus the hoisted
    # v_mean term.
    x_var = torch.cat([emb, state.h_lang, state.h_att], dim=-1)
    z = mm(x_var, pk["w_att"], dt)
    zv = ctx.att_zv
    if z.shape[0] != zv.shape[0]:  # grouped ctx without beam_expand
        zv = zv.repeat_interleave(z.shape[0] // zv.shape[0], dim=0)
    h_att, c_att = lstm_gates(z + zv + params.att_lstm.b, state.c_att)
    return _finish_step(params, cfg, ctx, state, h_att, c_att)


def _finish_step(params: EditNetParams, cfg: ModelConfig,
                 ctx: EditNetContext, state: EditNetState,
                 h_att: torch.Tensor, c_att: torch.Tensor
                 ) -> tuple[EditNetState, torch.Tensor]:
    """Visual attention, SCMA and the Copy-LSTM, given the att-LSTM
    state."""
    dt = _cdt(cfg)
    pk = _packed(params, cfg)
    # 2. Visual attention over the regions (all valid: no mask).
    v_hat, _ = additive_attention(
        params.vis_attention, ctx.vis_keys, ctx.features, h_att, None,
        compute_dtype=dt, w_q=pk["vis_wq"])
    v_hat = v_hat.to(dt)
    gate = torch.sigmoid(mm(h_att, pk["gate_w"], dt) + params.vis_gate_b)
    v_hat = (gate * v_hat.float()).to(dt)
    # 3. SCMA: select a memory cell state from the caption encoder.
    c_star, _ = scma_select(
        params.scma, ctx.scma_keys, ctx.enc_cs, h_att, ctx.mask,
        mode=cfg.scma_select, compute_dtype=dt, w_q=pk["scma_wq"])
    # 4. Copy-LSTM language model.
    x_lang = torch.cat([v_hat.float(), h_att], dim=-1)
    h_lang, c_lang = copy_lstm_cell(
        params.lang_lstm, x_lang, state.h_lang, state.c_lang, c_star,
        compute_dtype=dt, packed=pk["lang"])
    new_state = EditNetState(h_att=h_att, c_att=c_att, h_lang=h_lang,
                             c_lang=c_lang)
    return new_state, h_lang


def step(params: EditNetParams, cfg: ModelConfig, ctx: EditNetContext,
         state: EditNetState, token: torch.Tensor
         ) -> tuple[EditNetState, torch.Tensor]:
    """One decode step with the full logits [B, V] fp32."""
    new_state, out = _step_hidden(params, cfg, ctx, state, token)
    dt = _cdt(cfg)
    logits = mm(out, _packed(params, cfg)["fc_w"], dt) + params.fc_b
    return new_state, logits


def prepare_topk(params: EditNetParams, cfg: ModelConfig,
                 ctx: EditNetContext, k: int) -> EditNetContext:
    """Once per decode batch: the fused-cell pack when ``cell_impl ==
    "pallas"`` and SCMA is soft, and the head: quantized
    (``quantize_head``) under ``head_quant="int8"``, else padded
    (``prepad_head``) for the kernel."""
    if cfg.cell_impl == "pallas" and cfg.scma_select == "soft":
        ctx = ctx.replace(cell_pack=prepare_cell_pack(params, cfg, ctx))
    return prepare_head(params, cfg, ctx)


def prepare_head(params, cfg: ModelConfig, ctx):
    """The per-batch head of ``prepare_topk``, shared with DCNet."""
    if cfg.head_quant == "int8":
        w_q, scale, b_p = quantize_head(params.fc_w, params.fc_b)
        return ctx.replace(head_w=w_q, head_b=b_p, head_scale=scale)
    if cfg.head_impl == "xla":
        return ctx
    w_p, b_p = prepad_head(params.fc_w, params.fc_b,
                           compute_dtype=_cdt(cfg))
    return ctx.replace(head_w=w_p, head_b=b_p)


def step_topk(params: EditNetParams, cfg: ModelConfig, ctx: EditNetContext,
              state: EditNetState, token: torch.Tensor, k: int):
    """Decode step with the fused head: (state, top-k logits, their vocab
    ids, log-sum-exp), without the [B, V] logits."""
    new_state, out = _step_hidden(params, cfg, ctx, state, token)
    vals, idx, lse = _head_topk(params, cfg, ctx, out, k)
    return new_state, vals, idx, lse


def _head_topk(params: EditNetParams, cfg: ModelConfig,
               ctx: EditNetContext, out: torch.Tensor, k: int):
    """The vocab-head top-k: under ``head_quant="int8"`` the int8 kernel
    (or, with ``head_impl="xla"``, its plain version) over the fp32 hidden
    state; else the float kernel (``head_impl="pallas"``, the default, with
    ``head_extract``) or the plain full-logits head (``"xla"``)."""
    dt = _cdt(cfg)
    if cfg.head_quant == "int8":
        if ctx.head_scale is None:  # no prepare_topk: quantize here
            w_q, scale, b_p = quantize_head(params.fc_w, params.fc_b)
        else:
            w_q, scale, b_p = ctx.head_w, ctx.head_scale, ctx.head_b
        # The int8 head quantizes the fp32 rows itself: no bf16 cast.
        h = out.float().contiguous()
        if cfg.head_impl == "xla":
            return reference_head_topk_int8(h, w_q, scale, b_p, k)
        return fused_head_topk_int8(h, w_q, scale, b_p, k=k,
                                    extract=cfg.head_extract)
    if cfg.head_impl == "xla":
        return reference_head_topk(out.to(dt), params.fc_w.to(dt),
                                   params.fc_b, k)
    if ctx.head_w is None:
        raise ValueError("step_topk needs the head from prepare_topk")
    return fused_head_topk(out.to(dt).contiguous(), ctx.head_w, ctx.head_b,
                           k=k, extract=cfg.head_extract)


def check_ported_options(cfg: ModelConfig) -> None:
    """Raise on the kernel options the port does not have yet."""
    if cfg.cell_impl == "wholestep":
        raise NotImplementedError(
            "cell_impl='wholestep' (the fused lang cell + head kernel) is "
            "not ported yet; use 'pallas' or 'xla'")


def make_model(cfg: ModelConfig) -> ModelDef:
    check_ported_options(cfg)
    return ModelDef(
        name="editnet",
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
