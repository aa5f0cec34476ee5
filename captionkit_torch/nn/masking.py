"""Masking helpers and the masked training metrics
(``captionkit.nn.masking``).

``NEG_INF`` is the attention-mask and beam-search constant. The vocab head
pads with its own, larger constant (``kernels.head.HEAD_PAD``); the two are
kept apart as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] int lengths -> [B, max_len] bool (True = real token)."""
    pos = torch.arange(max_len, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def mask_logits(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Set masked positions to NEG_INF (softmax-safe)."""
    return torch.where(mask, logits, torch.full_like(logits, NEG_INF))


def masked_cross_entropy(logits: torch.Tensor,  # [B, T, V]
                         targets: torch.Tensor,  # [B, T] int
                         mask: torch.Tensor,  # [B, T] bool/float
                         *, label_smoothing: float = 0.0,
                         denominator: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Token-mean masked cross-entropy over the float32 log-softmax, with
    optional label smoothing toward the uniform distribution.
    ``denominator`` replaces the mask's own count (data parallelism: the
    global batch's, so the ranks' losses add up to the global mean)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    if label_smoothing > 0.0:
        smooth = -logp.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    mask = mask.float()
    den = mask.sum() if denominator is None else denominator
    return (nll * mask).sum() / torch.clamp(den, min=1.0)


def top5_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor, *,
                  denominator: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Share of counted steps whose target is in the top 5: a rank count
    (fewer than 5 logits strictly above the target's), not a sort.
    ``denominator`` as in ``masked_cross_entropy``."""
    tgt = torch.gather(logits, -1, targets.long()[..., None])
    rank = (logits > tgt).sum(dim=-1)  # [B, T]
    mask = mask.float()
    den = mask.sum() if denominator is None else denominator
    return ((rank < 5).float() * mask).sum() / torch.clamp(den, min=1.0)
