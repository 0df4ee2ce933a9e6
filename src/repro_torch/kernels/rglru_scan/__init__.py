from .ops import RGLRUScan, rglru_scan, rglru_scan_bwd  # noqa: F401
from .ref import rglru_scan_backward_ref, rglru_scan_ref  # noqa: F401
