"""The least time of the expert layer's grouped products (the yardstick of
``moe.experts_roofline``), beside ``roofline.py``'s bounds and on its
peaks.

A call of ``grouped_experts`` over S token-slots runs, for each slot, the
gate and up products of its expert (2 H 2I FLOPs) and the down product
(2 I H): 6 S H I FLOPs in bf16. It reads the weights of the experts that
got a slot once (3 H I bf16 each), the slots' rows in and writes their
rows out (H bf16 each); the gate and up outputs between the products are
the call's own and are not counted. The least time is the larger of the
FLOPs at the bf16 peak and the bytes at the memory's.
"""

from __future__ import annotations

from ckbench.roofline import PEAK_BF16_FLOPS, PEAK_BYTES


def experts_flops(slots: int, H: int, I: int) -> int:
    return 6 * slots * H * I


def experts_bytes(slots: int, experts_hit: float, H: int, I: int) -> float:
    return 2 * (3 * H * I * experts_hit + 2 * slots * H)


def experts_bound_s(slots: int, experts_hit: float, H: int, I: int
                    ) -> float:
    """Seconds: the longer of the products and the bytes."""
    return max(experts_flops(slots, H, I) / PEAK_BF16_FLOPS,
               experts_bytes(slots, experts_hit, H, I) / PEAK_BYTES)
