"""Host->device feed of the region features (``decode.feed_dtype``;
``captionkit.data.featquant``).

"float32" ships the features as they are; "bfloat16" casts them on the
host, which halves the transfer (the model stores its visual context in
bfloat16 anyway); "int8" quantizes each region on the host, symmetric and
zero-point-free: scale = amax / 127, q = clip(rint(x / scale), -127, 127),
all-zero regions scale 1. A [36, 2048] fp32 region block (288 KiB) ships
as 72 KiB of int8 and 36 fp32 scales. The decode function moves the staged
feed to the device (``feed_to_device``) and, for "int8", dequantizes it
there (``dequantize_for_feed``): one fp32 multiply and one cast to the
bfloat16 grid the bfloat16 feed lands on, so the model sees the same kind
of input. Element-wise error: |x - deq(q)| <= scale / 2 plus the bf16
rounding, under 0.8% of the region's largest magnitude.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

#: feed_dtype values the decode and serving paths accept.
FEED_DTYPES = ("float32", "bfloat16", "int8")
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8}

Staged = Union[None, torch.Tensor, tuple[torch.Tensor, torch.Tensor]]


def feed_torch_dtype(feed_dtype: str) -> torch.dtype:
    """The torch dtype that crosses the transfer for a ``feed_dtype``
    (int8 for "int8": the quantized values); raises for unknown names."""
    if feed_dtype not in _TORCH_DTYPES:
        raise ValueError("feed_dtype must be 'float32', 'bfloat16' or "
                         f"'int8', got {feed_dtype!r}")
    return _TORCH_DTYPES[feed_dtype]


def quantize_features(feats: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side: [..., R, F] float features -> (q int8 [..., R, F],
    scale float32 [..., R]). Symmetric per region; all-zero regions get
    scale 1.0 (q is then all zero, dequantization exact)."""
    feats = np.asarray(feats, np.float32)
    amax = np.max(np.abs(feats), axis=-1)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(feats / scale[..., None]), -127, 127)
    return q.astype(np.int8), scale


def dequantize_features(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Device-side: (q int8, scale fp32 [..., R]) -> bfloat16 features:
    an fp32 multiply, then one cast to bf16."""
    return (q.float() * scale[..., None]).to(torch.bfloat16)


def quantize_for_feed(feats: Optional[np.ndarray], feed_dtype: str
                      ) -> Staged:
    """Host-side staging: CPU tensors in the feed's form, the (q, scale)
    pair for "int8", else one tensor in the feed dtype. None passes
    through (text-only batches)."""
    dt = feed_torch_dtype(feed_dtype)
    if feats is None:
        return None
    if feed_dtype == "int8":
        q, scale = quantize_features(feats)
        return torch.from_numpy(q), torch.from_numpy(scale)
    return torch.from_numpy(np.ascontiguousarray(feats, np.float32)).to(dt)


def feed_to_device(staged: Staged, device: "str | torch.device") -> Staged:
    """Move a staged feed (tensor or (q, scale) pair) to ``device``."""
    if staged is None:
        return None
    if isinstance(staged, tuple):
        return tuple(t.to(device) for t in staged)
    return staged.to(device)


def dequantize_for_feed(features: Staged, feed_dtype: str
                        ) -> Optional[torch.Tensor]:
    """Undo ``quantize_for_feed`` on the device: for "int8" the (q, scale)
    pair becomes bf16 features; other feeds pass through (the model's
    ``encode`` does its own casts)."""
    if features is None or feed_dtype != "int8":
        return features
    if not (isinstance(features, tuple) and len(features) == 2):
        raise TypeError("feed_dtype='int8' expects the (q, scale) pair of "
                        "quantize_for_feed")
    q, scale = features
    return dequantize_features(q, scale)
