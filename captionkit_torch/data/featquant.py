"""Host->device feed of the region features (``decode.feed_dtype``).

"float32" ships the features as they are; "bfloat16" casts them on the
host, which halves the transfer (the model stores its visual context in
bfloat16 anyway); the decode function moves the staged tensor to the
device, where the model's ``encode`` does its own casts. The "int8" feed
of the reference (per-region symmetric quantization, dequantized on the
device) is not ported yet and raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def feed_torch_dtype(feed_dtype: str) -> torch.dtype:
    """The torch dtype of a ``decode.feed_dtype``; raises for "int8" and
    for unknown names."""
    if feed_dtype == "int8":
        raise NotImplementedError(
            "feed_dtype='int8' (device-side dequantization) is not ported "
            "yet; use 'float32' or 'bfloat16'")
    if feed_dtype not in _TORCH_DTYPES:
        raise ValueError("feed_dtype must be 'float32', 'bfloat16' or "
                         f"'int8', got {feed_dtype!r}")
    return _TORCH_DTYPES[feed_dtype]


def quantize_for_feed(
    feats: Optional[np.ndarray], feed_dtype: str
) -> Optional[torch.Tensor]:
    """Host-side staging: a CPU tensor in the feed dtype (None passes
    through, as for text-only batches)."""
    dt = feed_torch_dtype(feed_dtype)
    if feats is None:
        return None
    return torch.from_numpy(np.ascontiguousarray(feats, np.float32)).to(dt)

