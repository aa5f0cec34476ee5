"""Model registry: config.arch -> ModelDef."""

from __future__ import annotations

from captionkit_torch.config import ModelConfig
from captionkit_torch.models import editnet
from captionkit_torch.models.base import ModelDef

_REGISTRY = {
    "editnet": editnet.make_model,
}


def get_model(cfg: ModelConfig) -> ModelDef:
    if cfg.arch == "dcnet":
        raise NotImplementedError("arch='dcnet' is not ported yet")
    try:
        factory = _REGISTRY[cfg.arch]
    except KeyError:
        raise KeyError(
            f"unknown model arch {cfg.arch!r}; available: {sorted(_REGISTRY)}"
        ) from None
    return factory(cfg)
