from .ops import flash_attention  # noqa: F401
from .ref import sdpa_ref  # noqa: F401
