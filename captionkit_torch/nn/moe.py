"""The expert layer of Kimi-VL-A3B's language model (DeepSeek-V3's MoE):
routed SwiGLU experts chosen by a sigmoid router with a correction bias,
plus shared experts that every token runs.

* ``route``: float32 router logits (x W^T, as DeepSeek-V3 computes its
  gate), sigmoid scores; the top k of scores + correction bias are chosen
  (``topk_method`` noaux_tc with one group: no group limit), and the
  chosen tokens' weights are their scores without the bias, normalised to
  sum to 1 (``norm_topk_prob``) and scaled by ``routed_scaling_factor``.
* ``moe_layer``: the token-slots (N tokens x k choices) sorted by expert,
  the tokens gathered in that order, ``grouped_experts`` over them, the
  outputs put back in slot order and combined with the routing weights
  (one float32 product a token: deterministic), and the shared experts.
* ``grouped_experts``: gate and up as one grouped product over the
  sorted slots, SiLU(gate) * up, then the grouped down product. On a card
  each is one ``torch._grouped_mm`` over all experts (bf16, the groups'
  ends on the device: no host read); on the CPU a loop over the experts
  computes the same function (``grouped_experts_plain``).

Weights in the checkpoint's [out, in] layout, the experts stacked:
``experts_gate_up`` [E, 2 I, H] (gate rows first), ``experts_down``
[E, H, I]; the shared experts as one SwiGLU of width n_shared I.

In a profiler session the layer records spans ``moe.route``,
``moe.experts`` and ``moe.combine`` and, on the device, counters
``moe.slots`` (token-slots routed), ``moe.busiest`` (the busiest expert's
slots x E) and ``moe.experts_hit`` (experts that got a slot), read once a
batch (``utils/profiling.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from captionkit_torch.nn.cells import mm
from captionkit_torch.utils.profiling import annotate, count_device, enabled


@dataclass
class MoEParams:
    router: torch.Tensor  # [E, H]
    router_bias: torch.Tensor  # [E] correction bias (choice only)
    experts_gate_up: torch.Tensor  # [E, 2 I, H]
    experts_down: torch.Tensor  # [E, H, I]
    shared_gate_up: torch.Tensor  # [2 Is, H]
    shared_down: torch.Tensor  # [H, Is]


@dataclass(frozen=True)
class Routing:
    top_k: int
    scale: float  # routed_scaling_factor
    normalize: bool  # norm_topk_prob


def route(x: torch.Tensor, router: torch.Tensor, bias: torch.Tensor,
          r: Routing) -> tuple[torch.Tensor, torch.Tensor]:
    """(weights [N, k] fp32, expert ids [N, k] int64) of tokens x [N, H]."""
    scores = torch.sigmoid(x.float() @ router.float().t())
    idx = torch.topk(scores + bias.float(), r.top_k, dim=-1).indices
    weights = scores.gather(1, idx)
    if r.normalize and r.top_k > 1:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    return weights * r.scale, idx


def swiglu(gate_up: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """SiLU(gate) * up of [..., 2 I] (gate first) in gate_up's own dtype
    (the grouped products' bf16 outputs stay bf16, as the published model
    computes them), rounded to ``dt``."""
    I = gate_up.shape[-1] // 2
    return (F.silu(gate_up[..., :I]) * gate_up[..., I:]).to(dt)


def dense_swiglu(x: torch.Tensor, gate_up: torch.Tensor,
                 down: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """A dense SwiGLU MLP, out [N, H] fp32."""
    return mm(swiglu(mm(x, gate_up.t(), dt), dt), down.t(), dt)


def grouped_experts_plain(xs: torch.Tensor, ends: list, gate_up, down
                          ) -> torch.Tensor:
    """``grouped_experts`` as a loop over the experts, ``ends`` the groups'
    ends on the host: each product on the compute-dtype operands in
    float32, rounded to that dtype, as the grouped product rounds its
    output."""
    dt = xs.dtype
    out = torch.empty_like(xs)
    lo = 0
    for e, hi in enumerate(ends):
        if hi > lo:
            gu = (xs[lo:hi].float() @ gate_up[e].to(dt).float().t()).to(dt)
            out[lo:hi] = (swiglu(gu, dt).float()
                          @ down[e].to(dt).float().t()).to(dt)
        lo = hi
    return out


def grouped_experts(xs: torch.Tensor, ends: torch.Tensor,
                    gate_up: torch.Tensor, down: torch.Tensor
                    ) -> torch.Tensor:
    """The experts over the slots ``xs`` [S, H] sorted by expert (in the
    compute dtype), ``ends`` [E] int32 each expert's end in them:
    down_e(SiLU(gate_e x) * up_e x) [S, H]. A card takes the two grouped
    products (``grouped_products``; bf16 only), the CPU the plain loop."""
    if not xs.is_cuda:
        return grouped_experts_plain(xs, ends.tolist(), gate_up, down)
    if xs.dtype != torch.bfloat16:
        raise TypeError(f"the grouped expert products take bfloat16, got "
                        f"{xs.dtype}")
    return grouped_products(xs, ends, gate_up, down)


def grouped_products(xs, ends, gate_up, down) -> torch.Tensor:
    """Gate and up as one ``torch._grouped_mm`` over every expert, SiLU *
    up, then the grouped down product; the [out, in] weights read
    transposed, the groups' ends on the device."""
    gu = torch._grouped_mm(xs, gate_up.transpose(1, 2), offs=ends)
    return torch._grouped_mm(swiglu(gu, xs.dtype), down.transpose(1, 2),
                             offs=ends)


def moe_layer(x: torch.Tensor, p: MoEParams, r: Routing, dt: torch.dtype
              ) -> torch.Tensor:
    """The expert layer on normed tokens x [N, H] (float32): routed
    experts combined with their weights, plus the shared experts. out
    [N, H] fp32."""
    N, H = x.shape
    E, k = p.router.shape[0], r.top_k
    with annotate("moe.route"):
        weights, idx = route(x, p.router, p.router_bias, r)
        flat = idx.reshape(-1)
        order = torch.sort(flat, stable=True).indices  # slots by expert
        counts = torch.zeros(E, dtype=torch.int64, device=x.device)
        counts.index_add_(0, flat, torch.ones_like(flat))
        xs = x.to(dt).index_select(0, order // k)
        if enabled():
            count_device("moe.slots", counts.sum())
            count_device("moe.busiest", counts.max() * E)
            count_device("moe.experts_hit", (counts > 0).sum())
    with annotate("moe.experts"):
        ys = grouped_experts(xs, counts.cumsum(0).to(torch.int32),
                             p.experts_gate_up, p.experts_down)
    with annotate("moe.combine"):
        y = torch.empty_like(ys).index_copy_(0, order, ys).view(N, k, H)
        out = dense_swiglu(x, p.shared_gate_up, p.shared_down, dt)
        out += torch.bmm(weights[:, None, :], y.float())[:, 0]
    return out
