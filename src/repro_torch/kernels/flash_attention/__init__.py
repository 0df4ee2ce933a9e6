from .ops import FlashAttention, flash_attention  # noqa: F401
from .ref import flash_backward, sdpa_ref  # noqa: F401
