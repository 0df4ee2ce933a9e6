from .ops import ssd_intra_chunk, ssd_scan  # noqa: F401
from .ref import ssd_intra_chunk_ref, ssd_naive_ref, ssd_scan_ref  # noqa: F401
