from .base import ModelConfig  # noqa: F401
from .registry import ARCHS, get_config, smoke_config  # noqa: F401
