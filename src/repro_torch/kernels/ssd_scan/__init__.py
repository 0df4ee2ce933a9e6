from .ops import SSDIntraChunk, ssd_chunk_bwd, ssd_intra_chunk, ssd_scan  # noqa: F401
from .ref import (ssd_intra_chunk_backward_ref, ssd_intra_chunk_ref,  # noqa: F401
                  ssd_naive_ref, ssd_scan_ref)
