"""EditNet — visually grounded caption editor with SCMA + Copy-LSTM
(``captionkit.models.editnet``: serving and teacher forcing).

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

``cell_impl="xla"`` steps through plain PyTorch cells, which the step
asks ``nn.dispatch`` for at the reference's call sites (the Copy-LSTM and
the visual and SCMA attention; ``use_pallas=True`` there gives the cell
kernels of ``kernels/lstm.py`` and ``kernels/attention.py``). ``cell_impl=
"pallas"`` (soft SCMA) has ``prepare_topk`` build the fused-cell pack and
``_step_hidden`` run ``kernels/megastep.py::fused_step_hidden``; hard SCMA
keeps the plain cells, as in the reference. ``cell_impl="wholestep"``
builds the same pack and, with the float head, has ``step_topk`` run
``kernels/wholestep.py::fused_step_topk`` (the lang cell and the head in
one kernel); with the int8 or plain head it runs the ``pallas`` cells. The
vocab head of beam search is a CUDA kernel of ``kernels/head.py``: the
float head with either extraction (``head_extract``), or, with
``head_quant="int8"``, the int8 head over the fp32 hidden state and the
head quantized once per batch.

Training: ``step(train=True)`` applies dropout to h_lang with masks from
a ``torch.Generator`` and packs its weights from the live parameters
(``_pack``; ``_packed`` caches them for decoding). ``forward_seq`` is
teacher forcing with the state-independent work outside the loop and,
with ``deferred_backward`` and soft SCMA, the recurrence as
``editnet_backward.RecurrentSeq``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch

from captionkit_torch.config import ModelConfig
from captionkit_torch.device import resolve_device
from captionkit_torch.kernels.megastep import (
    CellPack,
    fused_step_hidden,
    prepare_cell_pack,
)
from captionkit_torch.kernels.wholestep import fused_step_topk
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
from captionkit_torch.models.editnet_backward import recurrent_seq
from captionkit_torch.nn.attention import (
    AdditiveAttentionParams,
    project_keys,
    scma_select,
)
from captionkit_torch.nn.cells import (
    CopyLSTMParams,
    LSTMParams,
    lstm_encode,
    lstm_gates,
    mm,
    pack_copy_lstm,
)
from captionkit_torch.nn.dispatch import (
    get_attention_fn,
    get_copy_lstm_cell_fn,
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
    # [Vp, Hp] int8, the int8 kernel's K-major copy of head_w (kmajor_head)
    head_wt: Optional[torch.Tensor] = None
    # Fused decode-cell pack, built by prepare_topk for cell_impl="pallas"
    # and "wholestep".
    cell_pack: Optional[CellPack] = None

    def replace(self, **kw) -> "EditNetContext":
        return dataclasses.replace(self, **kw)


@dataclass
class EditNetState:
    h_att: torch.Tensor  # [B, H]
    c_att: torch.Tensor
    h_lang: torch.Tensor
    c_lang: torch.Tensor


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


def _pack_finish(params: EditNetParams, cfg: ModelConfig) -> dict:
    """The weights of ``_finish_step`` rounded to the compute dtype, from
    the live parameters (gradients reach them)."""
    dt = compute_dtype(cfg)
    return {
        "gate_w": params.vis_gate_w.to(dt),
        "vis_wq": params.vis_attention.w_q.to(dt),
        "scma_wq": params.scma.w_q.to(dt),
        "lang": pack_copy_lstm(params.lang_lstm, dt),
    }


def _pack(params: EditNetParams, cfg: ModelConfig) -> dict:
    """The step's weights packed and rounded to the compute dtype (the
    reference's loop-invariant concats), from the live parameters."""
    dt = compute_dtype(cfg)
    E, F = cfg.emb_dim, cfg.feat_dim
    wx = params.att_lstm.wx
    w_att = torch.cat([wx[:E], wx[E + F:], params.att_lstm.wh], dim=0)
    return dict(_pack_finish(params, cfg), w_att=w_att.to(dt),
                fc_w=params.fc_w.to(dt))


def _packed(params: EditNetParams, cfg: ModelConfig) -> dict:
    """``_pack``, built once per parameter object and dtype for decoding
    (which XLA hoists out of the reference's decode loop)."""
    dt = compute_dtype(cfg)
    pk = params.cache.get(dt)
    if pk is None:
        pk = _pack(params, cfg)
        params.cache[dt] = pk
    return pk


def encode(params: EditNetParams, cfg: ModelConfig,
           features: torch.Tensor,  # [B, R, F]
           existing: torch.Tensor,  # [B, T]
           existing_len: torch.Tensor,  # [B]
           ) -> EditNetContext:
    dt = compute_dtype(cfg)
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


def init_state(params: EditNetParams, ctx: EditNetContext,
               max_len: Optional[int] = None) -> EditNetState:
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
                 token: torch.Tensor, use_pallas: bool = False,
                 generator: Optional[torch.Generator] = None,
                 train: bool = False, attn: Optional[dict] = None
                 ) -> tuple[EditNetState, torch.Tensor]:
    """One decode step up to the vocab head: (state, h_lang, dropped out
    when ``train``). ``use_pallas`` is handed to ``nn.dispatch`` at the
    plain step's cell call sites. ``train`` steps through the plain cells
    on weights packed from the live parameters (the fused cells have no
    backward and skip dropout, as in the reference). ``attn``, a dict,
    receives the step's attention distributions (``step_attn``); the
    plain cells compute them, so the fused pack is not taken then."""
    emb = params.embedding[token]  # [B, E]
    if ctx.cell_pack is not None and not train and attn is None:
        h_att, c_att, h_lang, c_lang = fused_step_hidden(
            ctx.cell_pack, state.h_att, state.c_att, state.h_lang,
            state.c_lang, emb)
        return EditNetState(h_att=h_att, c_att=c_att, h_lang=h_lang,
                            c_lang=c_lang), h_lang
    dt = compute_dtype(cfg)
    pk = _pack(params, cfg) if train else _packed(params, cfg)
    # 1. Attention LSTM over the step-varying inputs plus the hoisted
    # v_mean term.
    x_var = torch.cat([emb, state.h_lang, state.h_att], dim=-1)
    z = mm(x_var, pk["w_att"], dt)
    zv = ctx.att_zv
    if z.shape[0] != zv.shape[0]:  # grouped ctx without beam_expand
        zv = zv.repeat_interleave(z.shape[0] // zv.shape[0], dim=0)
    h_att, c_att = lstm_gates(z + zv + params.att_lstm.b, state.c_att)
    new_state, h_lang = _finish_step(params, cfg, ctx, state, h_att, c_att,
                                     pk, use_pallas, attn)
    return new_state, dropout(h_lang, cfg.dropout, generator, train)


def _finish_step(params: EditNetParams, cfg: ModelConfig,
                 ctx: EditNetContext, state: EditNetState,
                 h_att: torch.Tensor, c_att: torch.Tensor, pk: dict,
                 use_pallas: bool = False, attn: Optional[dict] = None
                 ) -> tuple[EditNetState, torch.Tensor]:
    """Visual attention, SCMA and the Copy-LSTM, given the att-LSTM
    state and the packed weights ``pk``. Returns (state, h_lang); ``attn``
    receives "vis_alpha" [B, R] (over the regions) and "beta" [B, T]
    (SCMA, over the existing caption's positions)."""
    dt = compute_dtype(cfg)
    copy_lstm_cell = get_copy_lstm_cell_fn(use_pallas)
    attention = get_attention_fn(use_pallas)
    # 2. Visual attention over the regions (all valid: no mask).
    v_hat, alpha = attention(
        params.vis_attention, ctx.vis_keys, ctx.features, h_att, None,
        compute_dtype=dt, w_q=pk["vis_wq"])
    v_hat = v_hat.to(dt)
    gate = torch.sigmoid(mm(h_att, pk["gate_w"], dt) + params.vis_gate_b)
    v_hat = (gate * v_hat.float()).to(dt)
    # 3. SCMA: select a memory cell state from the caption encoder.
    c_star, beta = scma_select(
        params.scma, ctx.scma_keys, ctx.enc_cs, h_att, ctx.mask,
        mode=cfg.scma_select, compute_dtype=dt, w_q=pk["scma_wq"],
        attention_fn=attention)
    if attn is not None:
        attn.update(vis_alpha=alpha, beta=beta)
    # 4. Copy-LSTM language model.
    x_lang = torch.cat([v_hat.float(), h_att], dim=-1)
    h_lang, c_lang = copy_lstm_cell(
        params.lang_lstm, x_lang, state.h_lang, state.c_lang, c_star,
        compute_dtype=dt, packed=pk["lang"])
    new_state = EditNetState(h_att=h_att, c_att=c_att, h_lang=h_lang,
                             c_lang=c_lang)
    return new_state, h_lang


def step(params: EditNetParams, cfg: ModelConfig, ctx: EditNetContext,
         state: EditNetState, token: torch.Tensor, use_pallas: bool = False,
         generator: Optional[torch.Generator] = None, train: bool = False
         ) -> tuple[EditNetState, torch.Tensor]:
    """One decode step with the full logits [B, V] fp32 (greedy and
    sampling decode, teacher forcing without ``forward_seq``).
    ``use_pallas=True`` takes the cell kernels at the dispatch call sites;
    ``train`` applies dropout to h_lang with masks from ``generator``."""
    new_state, out = _step_hidden(params, cfg, ctx, state, token,
                                  use_pallas, generator, train)
    return new_state, _logits(params, cfg, out, train)


def _logits(params: EditNetParams, cfg: ModelConfig, out: torch.Tensor,
            train: bool = False) -> torch.Tensor:
    """The vocab head on h_lang: logits [B, V] fp32."""
    dt = compute_dtype(cfg)
    fc_w = params.fc_w.to(dt) if train else _packed(params, cfg)["fc_w"]
    return mm(out, fc_w, dt) + params.fc_b


def step_attn(params: EditNetParams, cfg: ModelConfig, ctx: EditNetContext,
              state: EditNetState, token: torch.Tensor
              ) -> tuple[EditNetState, torch.Tensor, dict]:
    """Introspection step (``ModelDef.step_attn``): ``step``'s math and
    roundings on the plain cells, plus {"vis_alpha": [B, R] visual
    attention over the regions, "beta": [B, T] SCMA over the existing
    caption's positions}."""
    attn: dict = {}
    new_state, out = _step_hidden(params, cfg, ctx, state, token, attn=attn)
    return new_state, _logits(params, cfg, out), attn


def forward_seq(params: EditNetParams, cfg: ModelConfig,
                ctx: EditNetContext, state0: EditNetState,
                tokens_in: torch.Tensor,  # [B, T]
                generator: Optional[torch.Generator] = None,
                train: bool = False) -> torch.Tensor:
    """Teacher forcing (``ModelDef.forward_seq``): logits [B, T, V] fp32,
    row for row the math of a loop of ``step``, with the state-independent
    work outside the recurrence: the embedding gather of every step (one
    gather, so one scatter in the backward), the emb slice of the att-LSTM
    gate product with the hoisted v_mean term and the bias (zx), and the
    vocab head (one [B·T, H] x [H, V] product).

    With ``deferred_backward`` and soft SCMA (the defaults) the recurrence
    is ``editnet_backward.RecurrentSeq``, whose backward forms every large
    weight gradient once after its reverse loop; otherwise (hard SCMA, or
    ``deferred_backward=False``) autograd runs through the loop. Dropout
    keep masks are drawn step by step from ``generator`` (one seeded with
    0 when None) in the same order on both routes."""
    dt = compute_dtype(cfg)
    E, F = cfg.emb_dim, cfg.feat_dim
    B, T = tokens_in.shape
    H = params.fc_w.shape[0]
    dev = tokens_in.device
    wx = params.att_lstm.wx
    emb_seq = params.embedding[tokens_in]  # [B, T, E]
    z_x = mm(emb_seq, wx[:E], dt) + ctx.att_zv[:, None, :] \
        + params.att_lstm.b  # [B, T, 4H] fp32
    keep = None
    if train and cfg.dropout > 0.0:
        gen = default_generator(generator, dev)
        keep = [dropout_mask((B, H), cfg.dropout, gen, dev)
                for _ in range(T)]
    if cfg.deferred_backward and cfg.scma_select == "soft":
        outs = recurrent_seq(dt, cfg.dropout, ctx.mask,
                             None if keep is None else torch.stack(keep), {
            "w_rec_lang": wx[E + F:],
            "w_rec_att": params.att_lstm.wh,
            "lang_wx": params.lang_lstm.base.wx,
            "lang_wh": params.lang_lstm.base.wh,
            "lang_b": params.lang_lstm.base.b,
            "lang_wrx": params.lang_lstm.wrx,
            "lang_wrh": params.lang_lstm.wrh,
            "lang_wrc": params.lang_lstm.wrc,
            "lang_br": params.lang_lstm.br,
            "vis_wq": params.vis_attention.w_q,
            "vis_v": params.vis_attention.v,
            "vis_b": params.vis_attention.b,
            "gate_w": params.vis_gate_w,
            "gate_b": params.vis_gate_b,
            "scma_wq": params.scma.w_q,
            "scma_v": params.scma.v,
            "scma_b": params.scma.b,
            "vis_keys": ctx.vis_keys,
            "features": ctx.features,
            "scma_keys": ctx.scma_keys,
            "enc_cs": ctx.enc_cs,
            "h_att0": state0.h_att,
            "c_att0": state0.c_att,
            "h_lang0": state0.h_lang,
            "c_lang0": state0.c_lang,
            "zx": z_x.transpose(0, 1),
        }).transpose(0, 1)  # [B, T, H]
    else:
        # As in the reference's scan: w_rec is rounded once, outside the
        # loop, the step's other weights inside it (``_pack``), so each
        # step's gradient of those is rounded on its own and summed in
        # float32.
        w_rec = torch.cat([wx[E + F:], params.att_lstm.wh], dim=0).to(dt)
        state, outs = state0, []
        for t in range(T):
            hh = torch.cat([state.h_lang, state.h_att], dim=-1)
            z = z_x[:, t] + mm(hh, w_rec, dt)
            h_att, c_att = lstm_gates(z, state.c_att)
            state, out = _finish_step(params, cfg, ctx, state, h_att, c_att,
                                      _pack_finish(params, cfg))
            if keep is not None:
                out = apply_dropout_mask(out, keep[t], cfg.dropout)
            outs.append(out)
        outs = torch.stack(outs, dim=1)
    return mm(outs, params.fc_w, dt) + params.fc_b


def prepare_topk(params: EditNetParams, cfg: ModelConfig,
                 ctx: EditNetContext, k: int) -> EditNetContext:
    """Once per decode batch: the fused-cell pack when ``cell_impl`` is
    "pallas" or "wholestep" and SCMA is soft, and the head
    (``prepare_head``)."""
    return prepare_head(params, cfg, prepare_cells(params, cfg, ctx))


def prepare_cells(params: EditNetParams, cfg: ModelConfig,
                  ctx: EditNetContext) -> EditNetContext:
    """The fused-cell pack of ``prepare_topk`` (``cell_impl`` "pallas" or
    "wholestep", soft SCMA), without the head."""
    if cfg.cell_impl in ("pallas", "wholestep") and \
            cfg.scma_select == "soft":
        ctx = ctx.replace(cell_pack=prepare_cell_pack(params, cfg, ctx))
    return ctx


def step_topk(params: EditNetParams, cfg: ModelConfig, ctx: EditNetContext,
              state: EditNetState, token: torch.Tensor, k: int):
    """Decode step with the fused head: (state, top-k logits, their vocab
    ids, log-sum-exp), without the [B, V] logits. ``cell_impl=
    "wholestep"`` with a prepared pack and the float kernel head runs the
    whole-step kernel (its extraction is always "mask", as the
    reference's); everything else runs the cells, then
    ``base.configured_head_topk``."""
    if (cfg.cell_impl == "wholestep" and ctx.cell_pack is not None
            and cfg.head_impl == "pallas" and cfg.head_quant == "none"):
        # prepare_topk built the pack and, for this head, the padded head.
        h_att, c_att, h_lang, c_lang, vals, idx, lse = fused_step_topk(
            ctx.cell_pack, state.h_att, state.c_att, state.h_lang,
            state.c_lang, params.embedding[token], ctx.head_w, ctx.head_b,
            k=k)
        return (EditNetState(h_att=h_att, c_att=c_att, h_lang=h_lang,
                             c_lang=c_lang), vals, idx, lse)
    new_state, out = _step_hidden(params, cfg, ctx, state, token)
    vals, idx, lse = configured_head_topk(params, cfg, ctx, out, k)
    return new_state, vals, idx, lse


def make_model(cfg: ModelConfig) -> ModelDef:
    return ModelDef(
        name="editnet",
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
