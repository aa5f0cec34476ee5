"""Models: the shared step protocol, EditNet, DCNet and Kimi-VL's language
model."""

from captionkit_torch.models.base import HeadInfo, ModelDef  # noqa: F401
from captionkit_torch.models.registry import get_model  # noqa: F401
