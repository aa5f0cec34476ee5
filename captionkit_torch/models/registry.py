"""Model registry: config.arch -> ModelDef."""

from __future__ import annotations

from captionkit_torch.config import ModelConfig
from captionkit_torch.models import dcnet, editnet, kimi_vl
from captionkit_torch.models.base import ModelDef

_REGISTRY = {
    "dcnet": dcnet.make_model,
    "editnet": editnet.make_model,
    "kimi_vl": kimi_vl.make_model,
}


def get_model(cfg: ModelConfig) -> ModelDef:
    try:
        factory = _REGISTRY[cfg.arch]
    except KeyError:
        raise KeyError(
            f"unknown model arch {cfg.arch!r}; available: {sorted(_REGISTRY)}"
        ) from None
    return factory(cfg)
