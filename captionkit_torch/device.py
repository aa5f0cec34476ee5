"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """The device an entry point runs on. The default is the card; the CPU
    is used only when the caller names it. Raises when a CUDA device is
    asked for and CUDA is absent — there is no silent move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
