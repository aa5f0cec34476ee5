"""Kimi-VL-A3B's language model (moonshotai, Kimi-VL-A3B-Instruct; the
DeepSeek-V3 layout) as a caption editor: its weights, the port's model,
the plain float32 reference, the head and the FLOPs of a caption.

The prompt is [the regions through Kimi-VL's MLP projector ; the existing
caption's ids]; the decode starts with <start> after it. Reference, per
layer: RMSNorm, MLA (q_lora_rank null: q = x Wq^T; [c_kv | k_pe] =
x Wkva^T; per-head k_nope, v from RMSNorm(c_kv) Wkvb^T; DeepSeek-V3's
de-interleaved rope on the rope halves, theta ``rope_theta``; scores
scaled by (dn + dr)^-1/2, softmax, o Wo^T), residual; RMSNorm, the MLP
(dense SwiGLU in the first ``first_k_dense_replace`` layers, else
sigmoid routing with the correction bias in the choice only, the chosen
scores normalised and scaled, the routed experts and the shared ones),
residual; the final RMSNorm and the head. Its state is the float32
latent of the positions generated so far (normalised c_kv and rotated
k_pe, [B, L, t, c + dr]), decompressed at every step: the tier-1 tests
hold that form equal to the cache-free forward of ``tests/
kimi_vl_reference.py``.

The weights are drawn once, in bfloat16, on the device, in the port's
layout ([out, in] linears, experts stacked [E, ...], ``lm_head`` [H, V]):
the float32 model does not fit the card (64 GB). The reference upcasts
each array where it uses it, so it computes in float32 on the same
values, every matrix product through ``w.mm``. The weights dict carries
the configuration's model fields under ``"model"``, where the reference
reads its sizes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ckbench import inputs

PROJECTOR_EPS = 1e-5


def weight_table(m: dict) -> list[tuple[str, tuple, float, float]]:
    """(name, shape, scale, offset) of every array, uniform in
    [offset - scale, offset + scale): linears at their input width^-1/2,
    the projections into the residual stream (o_proj and every down
    projection) (2 L)^-1/2 smaller (GPT-2's init for L layers: the stream
    stays of unit scale and one layer moves it a little), norms about 1,
    the router at 3 H^-1/2 (sigmoid scores spread over (0.05, 0.95)), the
    correction bias at 0.1, the head at 3^1/2 H^-1/2 (logits of unit
    variance)."""
    H, V, F_, Pj = (m["hidden_dim"], m["vocab_size"], m["feat_dim"],
                    m["projector_dim"])
    n, dn, dr, dv, c = (m["num_heads"], m["qk_nope_head_dim"],
                        m["qk_rope_head_dim"], m["v_head_dim"],
                        m["kv_lora_rank"])
    E, Ie, I = (m["n_routed_experts"], m["moe_intermediate_size"],
                m["intermediate_size"])
    Is = m["n_shared_experts"] * Ie
    r = (2 * m["num_layers"]) ** -0.5
    out = [("projector/norm_w", (F_,), 0.1, 1.0),
           ("projector/norm_b", (F_,), 0.1, 0.0),
           ("projector/fc1_w", (Pj, F_), F_ ** -0.5, 0.0),
           ("projector/fc1_b", (Pj,), 0.1, 0.0),
           ("projector/fc2_w", (H, Pj), Pj ** -0.5, 0.0),
           ("projector/fc2_b", (H,), 0.1, 0.0),
           ("embed_tokens", (V, H), 1.0, 0.0)]
    for i in range(m["num_layers"]):
        p = f"layers/{i}/"
        out += [(p + "input_norm", (H,), 0.1, 1.0),
                (p + "attn/q_proj", (n * (dn + dr), H), H ** -0.5, 0.0),
                (p + "attn/kv_a", (c + dr, H), H ** -0.5, 0.0),
                (p + "attn/kv_a_norm", (c,), 0.1, 1.0),
                (p + "attn/kv_b", (n * (dn + dv), c), c ** -0.5, 0.0),
                (p + "attn/o_proj", (H, n * dv), r * (n * dv) ** -0.5, 0.0),
                (p + "post_norm", (H,), 0.1, 1.0)]
        if i < m["first_k_dense_replace"]:
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


def make_weights(m: dict, seed: int, device) -> dict:
    """{name: bfloat16 tensor on ``device``} from ``seed``, one array at
    a time (drawn in float32, rounded once), and ``"model"``: the model
    fields."""
    gen = torch.Generator(device=device).manual_seed(
        inputs.torch_seed(seed, 1))
    out = {}
    for name, shape, scale, offset in weight_table(m):
        t = torch.rand(shape, generator=gen, device=device)
        out[name] = t.mul_(2 * scale).add_(offset - scale).to(torch.bfloat16)
        del t
    out["model"] = dict(m)
    return out


def program(model: dict, weights: dict, device):
    """The port's model over the drawn tensors themselves (no copy), with
    the benchmark's marks around its new wrappers (``kimi_marks``)."""
    from captionkit_torch.config import ModelConfig
    from captionkit_torch.models import get_model
    from captionkit_torch.params import kimi_vl_params_from_tensors

    from ckbench import kimi_marks

    cfg = ModelConfig(**model)
    params = kimi_vl_params_from_tensors(weights, cfg)
    kimi_marks.install()
    return cfg, get_model(cfg), params


def head(weights) -> tuple:
    w = weights["lm_head"]
    return w.float(), torch.zeros(w.shape[1], device=w.device)


def reads_features(m: dict) -> bool:
    return True


# -- the plain float32 reference ---------------------------------------

def _f(t):
    return t.float()


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * _f(w)


def _rotate(x, positions, theta):
    """DeepSeek-V3's rope of x [B, S, ..., d] at positions [B, S]."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    f = positions.float()[..., None] * inv
    emb = torch.cat([f, f], dim=-1)
    shape = positions.shape + (1,) * (x.dim() - 3) + (d,)
    cos, sin = emb.cos().view(shape), emb.sin().view(shape)
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    return x * cos + torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1) * sin


def _q_latent(w, p, m, x, positions):
    """(q [B, S, n, dn + dr], latent [B, S, c + dr]) of normed x
    [B, S, H]."""
    n, dn, dr, c = (m["num_heads"], m["qk_nope_head_dim"],
                    m["qk_rope_head_dim"], m["kv_lora_rank"])
    q = w.mm(x, _f(w[p + "attn/q_proj"]).t()).unflatten(-1, (n, dn + dr))
    kva = w.mm(x, _f(w[p + "attn/kv_a"]).t())
    theta = m["rope_theta"]
    q = torch.cat([q[..., :dn], _rotate(q[..., dn:], positions, theta)], -1)
    lat = torch.cat([_rms(kva[..., :c], w[p + "attn/kv_a_norm"],
                          m["rms_norm_eps"]),
                     _rotate(kva[..., c:], positions, theta)], -1)
    return q, lat


def _attend(w, p, m, q, keys, mask):
    """q [B, Sq, n, dn + dr] over the latent ``keys`` [B, Sk, c + dr],
    decompressed per head, ``mask`` [B, Sq, Sk]: out [B, Sq, H]."""
    n, dn, dv, c = (m["num_heads"], m["qk_nope_head_dim"], m["v_head_dim"],
                    m["kv_lora_rank"])
    B, Sk = keys.shape[:2]
    kv = w.mm(keys[..., :c], _f(w[p + "attn/kv_b"]).t()).unflatten(
        -1, (n, dn + dv))
    k = torch.cat([kv[..., :dn], keys[:, :, None, c:].expand(
        B, Sk, n, keys.shape[-1] - c)], -1)
    s = w.mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) \
        * q.shape[-1] ** -0.5
    probs = torch.softmax(s.masked_fill(~mask[:, None], float("-inf")), -1)
    o = w.mm(probs, kv[..., dn:].transpose(1, 2)).transpose(1, 2)
    return w.mm(o.flatten(-2), _f(w[p + "attn/o_proj"]).t())


def _swiglu(w, x, gate_up, down):
    gu = w.mm(x, _f(gate_up).t())
    half = gu.shape[-1] // 2
    return w.mm(F.silu(gu[..., :half]) * gu[..., half:], _f(down).t())


def _mlp(w, p, m, i, x):
    """The layer's MLP on tokens x [N, H]: the routed experts a group of
    tokens at a time (their counts read on the host)."""
    if i < m["first_k_dense_replace"]:
        return _swiglu(w, x, w[p + "mlp/gate_up"], w[p + "mlp/down"])
    k = m["num_experts_per_tok"]
    scores = torch.sigmoid(w.mm(x, _f(w[p + "moe/router"]).t()))
    idx = torch.topk(scores + _f(w[p + "moe/router_bias"]), k, -1).indices
    weights = scores.gather(1, idx)
    if m["norm_topk_prob"]:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    weights = weights * m["routed_scaling_factor"]
    order = torch.argsort(idx.reshape(-1), stable=True)
    counts = torch.bincount(idx.reshape(-1),
                            minlength=m["n_routed_experts"]).tolist()
    xs = x[order // k]
    ys = torch.empty_like(xs)
    lo = 0
    for e, cnt in enumerate(counts):
        if cnt:
            ys[lo:lo + cnt] = _swiglu(w, xs[lo:lo + cnt],
                                      w[p + "moe/experts_gate_up"][e],
                                      w[p + "moe/experts_down"][e])
        lo += cnt
    y = torch.empty_like(ys).index_copy_(0, order, ys).view(x.shape[0], k, -1)
    return (_swiglu(w, x, w[p + "moe/shared_gate_up"],
                    w[p + "moe/shared_down"])
            + (y * weights[..., None]).sum(1))


def _project(w, features):
    x = F.layer_norm(features.float(), (features.shape[-1],),
                     _f(w["projector/norm_w"]), _f(w["projector/norm_b"]),
                     eps=PROJECTOR_EPS)
    x = F.gelu(w.mm(x, _f(w["projector/fc1_w"]).t())
               + _f(w["projector/fc1_b"]))
    return w.mm(x, _f(w["projector/fc2_w"]).t()) + _f(w["projector/fc2_b"])


def encode(w, features, existing, lengths):
    """The prompt's latent at every layer: {"prefix" [B, L, P, c + dr],
    "valid" [B, P], "plen" [B]}, P = R + T positions, image b's first
    R + len_b valid."""
    m = w["model"]
    eps = m["rms_norm_eps"]
    vis = _project(w, features)
    B, R, H = vis.shape
    T = existing.shape[1]
    h = torch.cat([vis, _f(w["embed_tokens"])[existing.long()]], 1)
    plen = R + lengths.long().clamp(max=T)
    pos = torch.arange(R + T, device=h.device).expand(B, -1)
    valid = pos < plen[:, None]
    mask = valid[:, None, :] & (pos[:, None, :] <= pos[:, :, None])
    lats = []
    for i in range(m["num_layers"]):
        p = f"layers/{i}/"
        q, lat = _q_latent(w, p, m, _rms(h, w[p + "input_norm"], eps), pos)
        lats.append(lat)
        h = h + _attend(w, p, m, q, lat, mask)
        x = _rms(h, w[p + "post_norm"], eps)
        h = h + _mlp(w, p, m, i, x.flatten(0, 1)).view(B, R + T, H)
    return {"prefix": torch.stack(lats, 1), "valid": valid, "plen": plen}


def state0(w, ctx):
    """(the generated positions' latent [B, L, 0, c + dr],)"""
    B, L, _, W = ctx["prefix"].shape
    return (ctx["prefix"].new_zeros(B, L, 0, W),)


def step(w, ctx, state, token):
    """(state, logits [B, V]) of one token a row at position plen + t."""
    m = w["model"]
    eps = m["rms_norm_eps"]
    (gen,) = state
    t = gen.shape[2]
    pos = (ctx["plen"] + t)[:, None]
    h = _f(w["embed_tokens"])[token.long()][:, None]  # [B, 1, H]
    mask = torch.cat([ctx["valid"], ctx["valid"].new_ones(
        gen.shape[0], t + 1)], 1)[:, None, :]
    new = []
    for i in range(m["num_layers"]):
        p = f"layers/{i}/"
        q, lat = _q_latent(w, p, m, _rms(h, w[p + "input_norm"], eps), pos)
        new.append(lat)
        keys = torch.cat([ctx["prefix"][:, i], gen[:, i], lat], 1)
        h = h + _attend(w, p, m, q, keys, mask)
        x = _rms(h, w[p + "post_norm"], eps)
        h = h + _mlp(w, p, m, i, x[:, 0])[:, None]
    gen = torch.cat([gen, torch.stack(new, 1)], 2)
    return (gen,), w.mm(_rms(h[:, 0], w["norm"], eps), _f(w["lm_head"]))


reference = (encode, state0, step)


# -- FLOPs -------------------------------------------------------------

def _layer_flops(m: dict, i: int) -> dict:
    """Per token: the projections ("proj"), the MLP ("mlp"); per attended
    pair: decompressed ("pair") and absorbed ("pair_lat") attention; per
    token the decompression ("kv_b") and the absorption ("absorb")."""
    H = m["hidden_dim"]
    n, dn, dr, dv, c = (m["num_heads"], m["qk_nope_head_dim"],
                        m["qk_rope_head_dim"], m["v_head_dim"],
                        m["kv_lora_rank"])
    proj = 2 * H * n * (dn + dr) + 2 * H * (c + dr) + 2 * n * dv * H
    if i < m["first_k_dense_replace"]:
        mlp = 6 * H * m["intermediate_size"]
    else:
        Ie = m["moe_intermediate_size"]
        mlp = (2 * H * m["n_routed_experts"]
               + 6 * H * Ie * (m["num_experts_per_tok"]
                               + m["n_shared_experts"]))
    return {"proj": proj, "mlp": mlp, "kv_b": 2 * c * n * (dn + dv),
            "pair": 2 * n * (dn + dr) + 2 * n * dv,
            "absorb": 2 * n * dn * c + 2 * n * c * dv,
            "pair_lat": 2 * n * (c + dr) + 2 * n * c}


def caption_flops(m: dict, *, beam: int, steps: int, t: int) -> int:
    """One caption: the projector over the regions; the prefill of the
    R + t prompt positions (decompressed causal attention in every layer,
    the MLP in all but the last, whose output no logit reads); then
    ``beam`` rows of ``steps`` steps, each in the absorbed form over the
    prompt and the row's positions so far, and the head."""
    R, F_, Pj, H = (m["num_regions"], m["feat_dim"], m["projector_dim"],
                    m["hidden_dim"])
    L, P = m["num_layers"], R + t
    total = R * (2 * F_ * Pj + 2 * Pj * H)
    for i in range(L):
        f = _layer_flops(m, i)
        total += P * (f["proj"] + f["kv_b"]) + P * (P + 1) // 2 * f["pair"]
        if i < L - 1:
            total += P * f["mlp"]
        for s in range(steps):
            total += beam * (f["proj"] + f["absorb"] + f["mlp"]
                             + (P + s + 1) * f["pair_lat"])
    return total + beam * steps * 2 * H * m["vocab_size"]
