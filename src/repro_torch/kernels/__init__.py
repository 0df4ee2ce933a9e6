"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version and a launch counter on its wrapper (``<wrapper>.launches``; a
wrapper with several kernels also counts each in ``.kernel_launches``).
A backward kernel has a wrapper of its own (``rglru_scan_bwd``,
``ssd_chunk_bwd``), called by the autograd Function beside its forward."""
from .fault_probe import probe_rows, probe_tree  # noqa: F401
from .flash_attention import flash_attention  # noqa: F401
from .rglru_scan import rglru_scan, rglru_scan_bwd  # noqa: F401
from .ssd_scan import ssd_chunk_bwd, ssd_scan  # noqa: F401

WRAPPERS = (flash_attention, probe_rows, probe_tree, rglru_scan, rglru_scan_bwd,
            ssd_scan, ssd_chunk_bwd)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
        for name in getattr(fn, "kernel_launches", {}):
            fn.kernel_launches[name] = 0


def launch_counts() -> dict:
    """``{wrapper or kernel name: launches}`` since the last reset: each
    wrapper's calls, and for a wrapper with several kernels
    (``flash_attention``, ``ssd_scan``) each kernel's launches too."""
    counts = {}
    for fn in WRAPPERS:
        counts[fn.__name__] = fn.launches
        counts.update(getattr(fn, "kernel_launches", {}))
    return counts
