"""Multi-head latent attention (MLA, DeepSeek-V2/V3), as Kimi-VL-A3B's
language model runs it (``q_lora_rank`` null), with RMSNorm and the
de-interleaved rotary embedding of DeepSeek-V3's modeling code.

Weights keep the published checkpoint's ``nn.Linear`` layout, [out, in]:
``q_proj`` [n (dn + dr), H], ``kv_a`` [c + dr, H] (``kv_a_proj_with_mqa``),
``kv_a_norm`` [c], ``kv_b`` [n (dn + dv), c], ``o_proj`` [H, n dv], with
n heads, dn = ``qk_nope_head_dim``, dr = ``qk_rope_head_dim``, dv =
``v_head_dim`` and c = ``kv_lora_rank``. Scores are scaled by
(dn + dr)^-1/2.

A position's cache entry is its latent [c + dr]: the normalised c_kv and
the rotated k_pe (shared by the heads). Two forms of the same attention:

* ``mla_prefill``: a prompt's positions at once, the latent decompressed
  into per-head keys and values (``kv_b``), causal, with a key mask.
* ``mla_decode``: one token a row over [its image's prefix latent ; the
  row's own generated latent], in the absorbed form: the query's nope part
  is taken into the latent space through kv_b's key half, both parts of
  the cache are scored against the [c + dr] latent and given one softmax,
  and the latent read-out leaves through kv_b's value half. The K beam
  rows of an image (rows b K .. b K + K - 1) share its prefix: one
  product scores the K x n queries of an image against it. The row's
  latent is written into its cache in place, at its step's position.

Products run on operands rounded to the compute dtype with float32
results (``nn.cells.mm``, ``bmm``); norms, rotations and the softmax are
float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from captionkit_torch.nn.cells import bmm, mm
from captionkit_torch.utils.profiling import annotate


@dataclass
class MLAParams:
    q_proj: torch.Tensor  # [n (dn + dr), H]
    kv_a: torch.Tensor  # [c + dr, H]
    kv_a_norm: torch.Tensor  # [c]
    kv_b: torch.Tensor  # [n (dn + dv), c]
    o_proj: torch.Tensor  # [H, n dv]


@dataclass(frozen=True)
class MLADims:
    heads: int
    nope: int  # dn
    rope: int  # dr
    v: int  # dv
    latent: int  # c
    eps: float

    @property
    def scale(self) -> float:
        return (self.nope + self.rope) ** -0.5


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x / rms(x) * w in float32."""
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def rope_tables(positions: torch.Tensor, dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [..., dim] float32 at integer ``positions`` [...]:
    frequencies theta^(-2i/dim), i < dim/2, each repeated over both
    halves."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, device=positions.device,
                                        dtype=torch.float32) / dim))
    f = positions.float()[..., None] * inv
    emb = torch.cat([f, f], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """DeepSeek-V3's rotation of x [..., d]: the interleaved pairs are
    first de-interleaved (even entries, then odd), then rotated by halves
    (x cos + rotate_half(x) sin). float32."""
    d = x.shape[-1]
    x = x.float().unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def _latent(p: MLAParams, d: MLADims, x, cos, sin, dt):
    """(q [..., n, dn + dr] fp32 with its rope part rotated, latent
    [..., c + dr] fp32: normalised c_kv and rotated k_pe) of normed x."""
    q = mm(x, p.q_proj.t(), dt).unflatten(-1, (d.heads, d.nope + d.rope))
    kv = mm(x, p.kv_a.t(), dt)
    ckv = rms_norm(kv[..., :d.latent], p.kv_a_norm, d.eps)
    k_pe = apply_rope(kv[..., d.latent:], cos, sin)
    q = torch.cat([q[..., :d.nope],
                   apply_rope(q[..., d.nope:], cos.unsqueeze(-2),
                              sin.unsqueeze(-2))], dim=-1)
    return q, torch.cat([ckv, k_pe], dim=-1)


def mla_prefill(p: MLAParams, d: MLADims, x: torch.Tensor,
                cos: torch.Tensor, sin: torch.Tensor, valid: torch.Tensor,
                dt: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal MLA over a prompt, decompressed: x [B, P, H] (normed), the
    rotations (cos, sin) [P, dr] of positions 0 .. P - 1, ``valid`` [B, P]
    the keys each image attends (its prompt's positions). Returns (out
    [B, P, H] fp32, latent [B, P, c + dr] fp32)."""
    B, P, _ = x.shape
    n = d.heads
    with annotate("mla.attend"):
        q, lat = _latent(p, d, x, cos, sin, dt)
        kv = mm(lat[..., :d.latent], p.kv_b.t(), dt).unflatten(
            -1, (n, d.nope + d.v))
        k = torch.cat([kv[..., :d.nope], lat[..., None, d.latent:].expand(
            B, P, n, d.rope)], dim=-1)
        q = q.transpose(1, 2).reshape(B * n, P, -1)
        k = k.transpose(1, 2).reshape(B * n, P, -1)
        v = kv[..., d.nope:].transpose(1, 2).reshape(B * n, P, d.v)
        s = bmm(q, k.transpose(1, 2), dt).view(B, n, P, P) * d.scale
        causal = torch.ones((P, P), dtype=torch.bool, device=x.device).tril()
        mask = causal[None, None] & valid[:, None, None, :]
        probs = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        o = bmm(probs.view(B * n, P, P), v, dt).view(B, n, P, d.v)
        out = mm(o.transpose(1, 2).reshape(B, P, n * d.v), p.o_proj.t(), dt)
    return out, lat


def mla_decode(p: MLAParams, d: MLADims, x: torch.Tensor,
               cos: torch.Tensor, sin: torch.Tensor, prefix: torch.Tensor,
               prefix_valid: torch.Tensor, gen: torch.Tensor,
               pos: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """One token a row, absorbed: x [R, H] (normed), (cos, sin) [R, dr]
    at each row's position; ``prefix`` [B, P, c + dr] the latent of each
    image's prompt (R = B K rows, image-major), ``prefix_valid`` [B, P];
    ``gen`` [R, G, c + dr] the rows' generated latent, into which the
    step's latent is written at ``pos`` [R] (in place), and which is
    attended through ``pos``. Returns out [R, H] fp32."""
    R = x.shape[0]
    B, P, _ = prefix.shape
    K, n, c = R // B, d.heads, d.latent
    with annotate("mla.attend"):
        q, lat = _latent(p, d, x, cos, sin, dt)
        rows = torch.arange(R, device=x.device)
        gen[rows, pos] = lat.to(gen.dtype)
        w = p.kv_b.view(n, d.nope + d.v, c)
        # the nope query into the latent space: [n, R, dn] x [n, dn, c]
        q_lat = bmm(q[..., :d.nope].transpose(0, 1), w[:, :d.nope], dt)
        qc = torch.cat([q_lat.transpose(0, 1), q[..., d.nope:]], dim=-1)
        s_pre = bmm(qc.reshape(B, K * n, c + d.rope), prefix.transpose(1, 2),
                    dt).view(R, n, P)
        s_gen = bmm(qc, gen.transpose(1, 2), dt)  # [R, n, G]
        G = gen.shape[1]
        gen_valid = torch.arange(G, device=x.device)[None] <= pos[:, None]
        mask = torch.cat([prefix_valid.repeat_interleave(K, dim=0),
                          gen_valid], dim=1)[:, None, :]
        s = torch.cat([s_pre, s_gen], dim=-1) * d.scale
        probs = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        o_lat = bmm(probs[..., :P].reshape(B, K * n, P), prefix[..., :c],
                    dt).view(R, n, c) + bmm(probs[..., P:], gen[..., :c], dt)
        # the latent read-out through kv_b's value half: [n, R, c] x
        # [n, c, dv]
        o = bmm(o_lat.transpose(0, 1), w[:, d.nope:].transpose(1, 2), dt)
        out = mm(o.transpose(0, 1).reshape(R, n * d.v), p.o_proj.t(), dt)
    return out
