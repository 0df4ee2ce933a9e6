from .ops import rglru_scan  # noqa: F401
from .ref import rglru_scan_ref  # noqa: F401
