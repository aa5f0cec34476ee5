"""Masking helpers (``captionkit.nn.masking``).

``NEG_INF`` is the attention-mask and beam-search constant. The vocab head
pads with its own, larger constant (``kernels.head.HEAD_PAD``); the two are
kept apart as in the reference.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] int lengths -> [B, max_len] bool (True = real token)."""
    pos = torch.arange(max_len, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def mask_logits(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Set masked positions to NEG_INF (softmax-safe)."""
    return torch.where(mask, logits, torch.full_like(logits, NEG_INF))
