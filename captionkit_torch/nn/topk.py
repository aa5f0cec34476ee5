"""Top-k with the reference's tie order.

``lax.top_k`` returns equal values lowest index first, and the beam search
relies on it: finished beams leave ``NEG_INF`` plateaus among the
candidates, and the finished-hypothesis register merges equal scores.
``torch.topk`` promises no order among ties, so every place where the
reference calls ``lax.top_k`` calls ``topk_lowest_index`` here.
"""

from __future__ import annotations

import torch


def topk_lowest_index(
    x: torch.Tensor, k: int, dim: int = -1
) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries along ``dim``, values
    descending, equal values in ascending index order. A stable descending
    sort keeps equal entries in their original (index) order."""
    vals, idx = torch.sort(x, dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)
