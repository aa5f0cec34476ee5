"""A plain float32 reference of Kimi-VL-A3B's language model as a caption
editor: the full forward of the published equations over one image's
[prompt ; tokens so far], with no cache, no batching and no kernel.

Source: Kimi-VL-A3B-Instruct's config.json (huggingface.co/moonshotai/
Kimi-VL-A3B-Instruct) and DeepSeek-V3's modeling code, whose layout its
language model follows:

* RMSNorm (x / sqrt(mean(x^2) + eps) * w) before attention and MLP, a
  final RMSNorm and an untied head (logits = h @ lm_head, [H, V]).
* MLA with q_lora_rank null: q = x Wq^T per head [dn | dr];
  [c_kv | k_pe] = x Wkva^T; k_nope, v = RMSNorm(c_kv) Wkvb^T per head;
  the rope halves of q and k (k_pe shared by the heads) rotated with
  DeepSeek-V3's de-interleaved rotary embedding (theta ``rope_theta``, no
  scaling); scores (q . k) (dn + dr)^-1/2, causal softmax, o = p v,
  out = o Wo^T.
* The first ``first_k_dense_replace`` layers a SwiGLU MLP
  (down(SiLU(gate x) * up x)), the rest DeepSeek-V3's MoE: sigmoid scores
  of float32 logits x Wr^T; the top ``num_experts_per_tok`` of scores +
  correction bias chosen (noaux_tc, one group); weights the chosen scores,
  normalised to sum 1 and times ``routed_scaling_factor``; the routed
  SwiGLU experts weighted and summed, plus the shared experts as one
  SwiGLU.

Departures from the published model:

* The vision tower (MoonViT) is not run: an image's 36 region features of
  width 2048 pass through Kimi-VL's projector (LayerNorm, Linear,
  GELU, Linear) with its input width set to 2048 in place of MoonViT's
  merged 4608.
* The prompt is [visual tokens ; the existing caption's ids], with no
  chat template; the decode starts with <start> after it.
* The vocabulary is a synthetic word map of ``vocab_size`` ids in place
  of Kimi's tokenizer.

Weights are the port's flat arrays by name (``captionkit_torch.models.
kimi_vl.weight_table``: [out, in] linears, experts stacked [E, ...],
``lm_head`` [H, V]), of any float type, each upcast where it is used.
This file imports no part of the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _f(t):
    return t.float()


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * _f(w)


def rotate(x, positions, theta):
    """DeepSeek-V3's apply_rotary_pos_emb on x [S, ..., d] at positions
    [S]: de-interleave (even entries, then odd), then x cos +
    rotate_half(x) sin with cos, sin of cat(freqs, freqs)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    freqs = positions.float()[:, None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (d,)
    cos, sin = emb.cos().view(shape), emb.sin().view(shape)
    x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(
        x.shape)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


def attention(w, p, m, x):
    """Causal MLA over x [S, H] (normed) at positions 0 .. S - 1."""
    S = x.shape[0]
    n, dn, dr, dv, c = (m["num_heads"], m["qk_nope_head_dim"],
                        m["qk_rope_head_dim"], m["v_head_dim"],
                        m["kv_lora_rank"])
    pos = torch.arange(S, device=x.device)
    q = (x @ _f(w[p + "attn/q_proj"]).t()).view(S, n, dn + dr)
    kva = x @ _f(w[p + "attn/kv_a"]).t()
    ckv = rms_norm(kva[:, :c], w[p + "attn/kv_a_norm"], m["rms_norm_eps"])
    k_pe = rotate(kva[:, c:], pos, m["rope_theta"])
    kv = (ckv @ _f(w[p + "attn/kv_b"]).t()).view(S, n, dn + dv)
    q = torch.cat([q[..., :dn], rotate(q[..., dn:], pos, m["rope_theta"])],
                  dim=-1)
    k = torch.cat([kv[..., :dn], k_pe[:, None, :].expand(S, n, dr)], dim=-1)
    scores = torch.einsum("qhd,khd->hqk", q, k) * (dn + dr) ** -0.5
    causal = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    o = torch.einsum("hqk,khd->qhd", probs, kv[..., dn:]).reshape(S, n * dv)
    return o @ _f(w[p + "attn/o_proj"]).t()


def swiglu(x, gate_up, down):
    gu = x @ _f(gate_up).t()
    inner = gu.shape[-1] // 2
    return (F.silu(gu[:, :inner]) * gu[:, inner:]) @ _f(down).t()


def route(x, router, bias, m):
    """(weights [S, k], expert ids [S, k]) of tokens x [S, H]."""
    scores = torch.sigmoid(x @ _f(router).t())
    idx = torch.topk(scores + _f(bias), m["num_experts_per_tok"], -1).indices
    weights = scores.gather(1, idx)
    if m["norm_topk_prob"]:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    return weights * m["routed_scaling_factor"], idx


def moe(w, p, m, x):
    weights, idx = route(x, w[p + "moe/router"], w[p + "moe/router_bias"], m)
    out = swiglu(x, w[p + "moe/shared_gate_up"], w[p + "moe/shared_down"])
    for e in range(w[p + "moe/router"].shape[0]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if len(tok):
            y = swiglu(x[tok], w[p + "moe/experts_gate_up"][e],
                       w[p + "moe/experts_down"][e])
            out = out.index_add(0, tok, y * weights[tok, slot][:, None])
    return out


def project(w, features):
    """Kimi-VL's MLP projector: [R, F] -> [R, H]."""
    x = F.layer_norm(features.float(), (features.shape[-1],),
                     _f(w["projector/norm_w"]), _f(w["projector/norm_b"]),
                     eps=1e-5)
    x = F.gelu(x @ _f(w["projector/fc1_w"]).t() + _f(w["projector/fc1_b"]))
    return x @ _f(w["projector/fc2_w"]).t() + _f(w["projector/fc2_b"])


def forward(w, m, features, caption, inputs):
    """Logits [n, V] at the positions of ``inputs`` (n ids: <start>, then
    the tokens so far) after the prompt [project(features [R, F]) ;
    caption ids [t]], one image."""
    h = torch.cat([project(w, features),
                   _f(w["embed_tokens"])[caption.long()],
                   _f(w["embed_tokens"])[inputs.long()]], dim=0)
    eps = m["rms_norm_eps"]
    for i in range(m["num_layers"]):
        p = f"layers/{i}/"
        h = h + attention(w, p, m, rms_norm(h, w[p + "input_norm"], eps))
        x = rms_norm(h, w[p + "post_norm"], eps)
        if i < m["first_k_dense_replace"]:
            h = h + swiglu(x, w[p + "mlp/gate_up"], w[p + "mlp/down"])
        else:
            h = h + moe(w, p, m, x)
    h = rms_norm(h[-len(inputs):], w["norm"], eps)
    return h @ _f(w["lm_head"])
