"""Kimi-VL-A3B's language model as a caption editor (``arch="kimi_vl"``).

Kimi-VL-A3B-Instruct (moonshotai, huggingface.co/moonshotai/
Kimi-VL-A3B-Instruct) is a vision-language model whose language model
follows DeepSeek-V3's layout: RMSNorm, multi-head latent attention
(``nn/mla.py``), the first ``first_k_dense_replace`` layers a dense
SwiGLU and the rest an expert layer (``nn/moe.py``), a final RMSNorm and
an untied head. Its vision tower is not run: the 36 region features of
an image pass through Kimi-VL's MLP projector (LayerNorm, Linear
F -> ``projector_dim``, GELU, Linear -> H) and become the image's visual
tokens.

* ``encode``: the prompt [visual tokens ; the existing caption's ids]
  (image b: R + len_b positions, padded to R + T) through every layer at
  once (``mla_prefill``), causal. The context keeps the per-image latent
  cache ``prefix`` [L, B, R + T, c + dr] in the compute dtype, each
  image's prompt length and the valid-position mask; ``beam_expand``
  repeats only the prompt length per beam, the prefix stays per image.
  The last layer's MLP has no reader in the prefill (no logits are taken
  there) and is not run.
* ``init_state``: the rows' generated latent ``cache`` [rows, L, G, c + dr]
  (G = the decode's ``max_len``, which the decode loops pass; zeros) and
  ``pos`` [rows], the tokens generated so far; beam search reorders both
  by rows.
* ``step`` / ``step_topk``: one token a row: rope positions continue from
  each row's prompt length; each layer's ``mla_decode`` writes the row's
  latent into ``cache`` in place (the state passed in is updated) and
  attends [prefix ; generated]; then the final norm and the vocab head
  (``step_topk``: the configured head of ``models/base.py``, the fused
  kernel at H = hidden_dim over ``vocab_size`` ids with a zero bias).

The residual stream is float32; every product runs on compute-dtype
operands with float32 results but the grouped expert products, whose
outputs are in the compute dtype (``nn/moe.py``). No step reads from the
device. Inside a profiler session the prefill is a ``kimi.prefill`` span
and ``init_state`` adds the latent cache's bytes to ``kv.cache_bytes``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from captionkit_torch.config import ModelConfig
from captionkit_torch.device import resolve_device
from captionkit_torch.models.base import (
    ModelDef,
    compute_dtype,
    configured_head_topk,
    head_info,
    prepare_head,
)
from captionkit_torch.nn import mla, moe
from captionkit_torch.nn.cells import mm
from captionkit_torch.nn.mla import MLADims, MLAParams, rms_norm, rope_tables
from captionkit_torch.nn.moe import MoEParams, Routing
from captionkit_torch.utils.profiling import annotate, count

PROJECTOR_EPS = 1e-5  # the projector's LayerNorm


@dataclass
class KimiLayer:
    input_norm: torch.Tensor  # [H]
    attn: MLAParams
    post_norm: torch.Tensor  # [H]
    gate_up: Optional[torch.Tensor] = None  # dense SwiGLU [2 I, H]
    down: Optional[torch.Tensor] = None  # [H, I]
    moe: Optional[MoEParams] = None  # the expert layer


@dataclass
class KimiVLParams:
    proj_norm_w: torch.Tensor  # [F]
    proj_norm_b: torch.Tensor  # [F]
    proj_fc1_w: torch.Tensor  # [Pj, F]
    proj_fc1_b: torch.Tensor  # [Pj]
    proj_fc2_w: torch.Tensor  # [H, Pj]
    proj_fc2_b: torch.Tensor  # [H]
    embed: torch.Tensor  # [V, H]
    layers: list
    norm: torch.Tensor  # [H]
    fc_w: torch.Tensor  # [H, V] the head (lm_head)
    fc_b: torch.Tensor  # [V] zeros: the head has no bias


@dataclass
class KimiVLContext:
    prefix: torch.Tensor  # [L, B, P, c + dr] latent of each image's prompt
    valid: torch.Tensor  # [B, P] bool
    prompt_len: torch.Tensor  # [B] (per beam row after beam_expand)
    head_w: Optional[torch.Tensor] = None
    head_b: Optional[torch.Tensor] = None
    head_scale: Optional[torch.Tensor] = None
    head_wt: Optional[torch.Tensor] = None

    def replace(self, **kw) -> "KimiVLContext":
        return dataclasses.replace(self, **kw)


@dataclass
class KimiVLState:
    pos: torch.Tensor  # [rows] int64, tokens generated so far
    cache: torch.Tensor  # [rows, L, G, c + dr] generated latent


def dims(cfg: ModelConfig) -> MLADims:
    return MLADims(heads=cfg.num_heads, nope=cfg.qk_nope_head_dim,
                   rope=cfg.qk_rope_head_dim, v=cfg.v_head_dim,
                   latent=cfg.kv_lora_rank, eps=cfg.rms_norm_eps)


def routing(cfg: ModelConfig) -> Routing:
    return Routing(top_k=cfg.num_experts_per_tok,
                   scale=cfg.routed_scaling_factor,
                   normalize=cfg.norm_topk_prob)


def weight_table(cfg: ModelConfig) -> list[tuple[str, tuple, float, float]]:
    """(name, shape, scale, offset) of every flat array: uniform in
    [offset - scale, offset + scale), scales of a width's inverse square
    root (norms about 1); the projections into the residual stream (o_proj
    and every down projection) scaled by (2 L)^-1/2 more, GPT-2's init
    for a stack of L layers."""
    H, V, F_, Pj = (cfg.hidden_dim, cfg.vocab_size, cfg.feat_dim,
                    cfg.projector_dim)
    n, dn, dr, dv, c = (cfg.num_heads, cfg.qk_nope_head_dim,
                        cfg.qk_rope_head_dim, cfg.v_head_dim,
                        cfg.kv_lora_rank)
    E, Ie, I = (cfg.n_routed_experts, cfg.moe_intermediate_size,
                cfg.intermediate_size)
    Is = cfg.n_shared_experts * Ie
    r = (2 * cfg.num_layers) ** -0.5
    out = [("projector/norm_w", (F_,), 0.1, 1.0),
           ("projector/norm_b", (F_,), 0.1, 0.0),
           ("projector/fc1_w", (Pj, F_), F_ ** -0.5, 0.0),
           ("projector/fc1_b", (Pj,), 0.1, 0.0),
           ("projector/fc2_w", (H, Pj), Pj ** -0.5, 0.0),
           ("projector/fc2_b", (H,), 0.1, 0.0),
           ("embed_tokens", (V, H), 1.0, 0.0)]
    for i in range(cfg.num_layers):
        p = f"layers/{i}/"
        out += [(p + "input_norm", (H,), 0.1, 1.0),
                (p + "attn/q_proj", (n * (dn + dr), H), H ** -0.5, 0.0),
                (p + "attn/kv_a", (c + dr, H), H ** -0.5, 0.0),
                (p + "attn/kv_a_norm", (c,), 0.1, 1.0),
                (p + "attn/kv_b", (n * (dn + dv), c), c ** -0.5, 0.0),
                (p + "attn/o_proj", (H, n * dv), r * (n * dv) ** -0.5, 0.0),
                (p + "post_norm", (H,), 0.1, 1.0)]
        if i < cfg.first_k_dense_replace:
            out += [(p + "mlp/gate_up", (2 * I, H), H ** -0.5, 0.0),
                    (p + "mlp/down", (H, I), r * I ** -0.5, 0.0)]
        else:
            out += [(p + "moe/router", (E, H), 3 * H ** -0.5, 0.0),
                    (p + "moe/router_bias", (E,), 0.1, 0.0),
                    (p + "moe/experts_gate_up", (E, 2 * Ie, H), H ** -0.5,
                     0.0),
                    (p + "moe/experts_down", (E, H, Ie), r * Ie ** -0.5,
                     0.0),
                    (p + "moe/shared_gate_up", (2 * Is, H), H ** -0.5, 0.0),
                    (p + "moe/shared_down", (H, Is), r * Is ** -0.5, 0.0)]
    return out + [("norm", (H,), 0.1, 1.0),
                  ("lm_head", (H, V), 3 ** 0.5 * H ** -0.5, 0.0)]


def init_tensors(seed: int, cfg: ModelConfig, device="cuda",
                 dtype=torch.float32) -> dict[str, torch.Tensor]:
    """Random flat weights by name from ``seed`` (``weight_table``), drawn
    on ``device`` (the card unless the caller names the CPU) an array at a
    time and rounded once to ``dtype``."""
    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, shape, scale, offset in weight_table(cfg):
        u = torch.rand(shape, generator=g, device=device)
        out[name] = u.mul_(2 * scale).add_(offset - scale).to(dtype)
    return out


def _mlp(layer: KimiLayer, cfg: ModelConfig, x: torch.Tensor,
         dt: torch.dtype) -> torch.Tensor:
    """The layer's MLP on normed tokens x [N, H]: out [N, H] fp32."""
    if layer.moe is None:
        return moe.dense_swiglu(x, layer.gate_up, layer.down, dt)
    return moe.moe_layer(x, layer.moe, routing(cfg), dt)


def project(params: KimiVLParams, features: torch.Tensor,
            dt: torch.dtype) -> torch.Tensor:
    """The MLP projector: region features [B, R, F] -> visual tokens
    [B, R, H] fp32."""
    x = F.layer_norm(features.float(), (features.shape[-1],),
                     params.proj_norm_w.float(), params.proj_norm_b.float(),
                     eps=PROJECTOR_EPS)
    x = F.gelu(mm(x, params.proj_fc1_w.t(), dt) + params.proj_fc1_b.float())
    return mm(x, params.proj_fc2_w.t(), dt) + params.proj_fc2_b.float()


def encode(params: KimiVLParams, cfg: ModelConfig, features: torch.Tensor,
           existing: torch.Tensor, existing_len: torch.Tensor
           ) -> KimiVLContext:
    dt = compute_dtype(cfg)
    with annotate("kimi.prefill"):
        vis = project(params, features, dt)
        B, R, H = vis.shape
        T = existing.shape[1]
        P = R + T
        h = torch.cat([vis, params.embed[existing].float()], dim=1)
        prompt_len = R + existing_len.to(torch.int64).clamp(max=T)
        dev = h.device
        valid = torch.arange(P, device=dev)[None] < prompt_len[:, None]
        cos, sin = rope_tables(torch.arange(P, device=dev),
                               cfg.qk_rope_head_dim, cfg.rope_theta)
        d = dims(cfg)
        prefix = torch.empty((len(params.layers), B, P,
                              d.latent + d.rope), dtype=dt, device=dev)
        last = len(params.layers) - 1
        for i, layer in enumerate(params.layers):
            x = rms_norm(h, layer.input_norm, d.eps)
            out, lat = mla.mla_prefill(layer.attn, d, x, cos, sin, valid, dt)
            prefix[i] = lat
            if i == last:  # nothing reads the last layer's MLP here
                break
            h = h + out
            x = rms_norm(h, layer.post_norm, d.eps)
            h = h + _mlp(layer, cfg, x.view(B * P, H), dt).view(B, P, H)
    return KimiVLContext(prefix=prefix, valid=valid, prompt_len=prompt_len)


def init_state(params: KimiVLParams, ctx: KimiVLContext,
               max_len: Optional[int] = None) -> KimiVLState:
    if max_len is None:
        raise ValueError("kimi_vl's decode state holds every generated "
                         "step's latent: init_state needs max_len, the "
                         "decode's step count")
    rows = ctx.prompt_len.shape[0]
    L, _, _, W = ctx.prefix.shape
    cache = torch.zeros((rows, L, max_len, W),
                        dtype=ctx.prefix.dtype, device=ctx.prefix.device)
    count("kv.cache_bytes", (cache.numel() + ctx.prefix.numel())
          * cache.element_size())
    return KimiVLState(pos=torch.zeros(rows, dtype=torch.int64,
                                       device=cache.device), cache=cache)


def beam_expand(ctx: KimiVLContext, k: int) -> KimiVLContext:
    """Only the prompt length is repeated per beam (rows b K .. b K + K -
    1); the prefix latent and its mask stay per image."""
    return ctx.replace(prompt_len=ctx.prompt_len.repeat_interleave(k, 0))


def step_hidden(params: KimiVLParams, cfg: ModelConfig, ctx: KimiVLContext,
                state: KimiVLState, token: torch.Tensor
                ) -> tuple[KimiVLState, torch.Tensor]:
    """One token a row through every layer, to the final norm: (state,
    h [rows, H] fp32). Writes the step's latent into ``state.cache``."""
    dt = compute_dtype(cfg)
    d = dims(cfg)
    rows = token.shape[0]
    plen = ctx.prompt_len
    if plen.shape[0] != rows:  # a context without beam_expand
        plen = plen.repeat_interleave(rows // plen.shape[0], 0)
    cos, sin = rope_tables(plen + state.pos, d.rope, cfg.rope_theta)
    h = params.embed[token.long()].float()
    for i, layer in enumerate(params.layers):
        x = rms_norm(h, layer.input_norm, d.eps)
        h = h + mla.mla_decode(layer.attn, d, x, cos, sin, ctx.prefix[i],
                               ctx.valid, state.cache[:, i], state.pos, dt)
        h = h + _mlp(layer, cfg, rms_norm(h, layer.post_norm, d.eps), dt)
    new_state = KimiVLState(pos=state.pos + 1, cache=state.cache)
    return new_state, rms_norm(h, params.norm, d.eps)


def step(params: KimiVLParams, cfg: ModelConfig, ctx: KimiVLContext,
         state: KimiVLState, token: torch.Tensor
         ) -> tuple[KimiVLState, torch.Tensor]:
    """One step with the full logits [rows, V] fp32."""
    new_state, h = step_hidden(params, cfg, ctx, state, token)
    return new_state, mm(h, params.fc_w, compute_dtype(cfg)) + params.fc_b


def step_topk(params: KimiVLParams, cfg: ModelConfig, ctx: KimiVLContext,
              state: KimiVLState, token: torch.Tensor, k: int):
    """(state, top-k logits, their ids, log-sum-exp) through the
    configured head (``base.configured_head_topk``)."""
    new_state, h = step_hidden(params, cfg, ctx, state, token)
    vals, idx, lse = configured_head_topk(params, cfg, ctx, h, k)
    return new_state, vals, idx, lse


def _init(seed: int, cfg: ModelConfig, device) -> KimiVLParams:
    from captionkit_torch.params import kimi_vl_params_from_tensors

    return kimi_vl_params_from_tensors(init_tensors(seed, cfg, device), cfg)


def make_model(cfg: ModelConfig) -> ModelDef:
    return ModelDef(
        name="kimi_vl",
        init=lambda seed, device="cuda": _init(seed, cfg, device),
        encode=lambda params, features, existing, existing_len: encode(
            params, cfg, features, existing, existing_len),
        init_state=init_state,
        step=lambda params, ctx, state, token, generator=None, train=False:
        step(params, cfg, ctx, state, token),
        beam_expand=beam_expand,
        step_topk=(
            (lambda params, ctx, state, token, k: step_topk(
                params, cfg, ctx, state, token, k))
            if cfg.use_fused_head else None),
        prepare_topk=(
            (lambda params, ctx, k: prepare_head(params, cfg, ctx))
            if cfg.use_fused_head else None),
        head_info=head_info(cfg),
    )
