"""Build and load the port's hand-written Hopper kernels.

Every ``kernels/*/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` — one
``nvcc -c`` per source, all started together — and the objects are linked
into one shared library with a plain C interface, loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds, not minutes). The library
lands in ``build/repro_torch_kernels/`` at the root of the checkout, named by
a hash of the sources, the headers and the flags, so an edited source or
header is never served a stale build; what ``nvcc -Xptxas -v`` printed for
each source is kept beside its object (:func:`compile_log`). Nothing is built when this module is
imported: the first kernel launch (or an explicit :func:`build`) does it.

Several threads may launch at once (the rank threads of a serve group), so
the first load is built once under a lock, and every wrapper counts its
launches through :func:`count_launch`, which no thread can lose an
increment of. Several processes may too (the worker processes of a
multi-host fleet, each loading the library): :func:`build` compiles under
an exclusive ``flock`` on a file in the build directory, checks for the
library again once it holds it, and writes every object and the library
under a process-unique name before it renames them into place, so a
process never reads a file another is still writing.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional

import torch

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_UL, _U = ctypes.c_ulonglong, ctypes.c_uint
# C signature of each exported launcher; every one returns cudaGetLastError()
SIGNATURES = {
    # q, k, v, q_offset, out, B, T, Hq, Hkv, D, causal, window, seq_kv,
    # splits, keys_per_split, rows per slot, stream
    "repro_flash_decode": (_P, _P, _P, _P, _P, _L, _L, _I, _I, _I, _I, _I, _L,
                           _I, _L, _I, _P),
    # q, k, v, q_offset, out, lse (null, or the training forward's), B, S,
    # T, Hq, Hkv, D, causal, window, seq_kv, stream
    "repro_flash_forward": (_P, _P, _P, _P, _P, _P, _L, _L, _L, _I, _I, _I, _I,
                            _I, _L, _P),
    "repro_flash_f32": (_P, _P, _P, _P, _P, _P, _L, _L, _L, _I, _I, _I, _I, _I,
                        _L, _P),
    # x, rows, cols, dtype, threshold, nonfinite_code, overflow_code, out,
    # stream
    "repro_probe_rows": (_P, _I, _L, _I, _F, _I, _I, _P, _P),
    # the leaves' pointers, counts, dtype codes and chunk ends (host arrays),
    # leaves, threshold, nonfinite_code, overflow_code, out, zero_out, stream
    "repro_probe_tree": (_P, _P, _P, _P, _I, _F, _I, _I, _P, _I, _P),
    # x_in, log_a, h_out, agg (scratch), B, S, W, T (chunk), stream
    "repro_rglru_scan": (_P, _P, _P, _P, _L, _L, _L, _L, _P),
    # x_in, log_a, h, dh, dx_in, dlog_a, the hand-off scratch, B, S, W, T,
    # the ticket base, the epoch, stream
    "repro_rglru_scan_bwd": (_P, _P, _P, _P, _P, _P, _P, _L, _L, _L, _L, _UL,
                             _U, _P),
    # x, dt, A, B, C, y, states, b, S, H, P, G, N, L, stream
    "repro_ssd_chunk_tc": (_P, _P, _P, _P, _P, _P, _P, _L, _L, _I, _I, _I, _I,
                           _I, _P),
    "repro_ssd_f32": (_P, _P, _P, _P, _P, _P, _P, _L, _L, _I, _I, _I, _I, _I,
                      _P),
    # x, dt, A, B, C, dy_diag, dstates, dx, ddt, dA (per batch, chunk and
    # head), dB, dC (per head), b, S, H, P, G, N, L, stream
    "repro_ssd_chunk_bwd_tc": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _L, _L, _I, _I, _I, _I, _I, _P),
    "repro_ssd_chunk_bwd_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _L, _L, _I, _I, _I, _I, _I, _P),
}

_lib: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def sources() -> list[Path]:
    return sorted(_KERNELS.glob("*/csrc/*.cu"))


def headers() -> list[Path]:
    """Every header the sources may include (``common/`` and any
    ``csrc/``): hashed with the sources, so an edited header rebuilds."""
    return sorted(_KERNELS.rglob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(found, os.X_OK):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built on the machine with the card")
    return found


def build() -> Path:
    """Compile every kernel source into one ``.so`` (cached by content)."""
    nvcc = _nvcc()
    srcs = sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + headers():
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    so = BUILD_DIR / f"libreprokernels-{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)          # released when closed
        if not so.exists():                       # another process built it
            _compile(nvcc, srcs, digest.hexdigest()[:16], so)
    return so


def _compile(nvcc: str, srcs: list[Path], digest: str, so: Path) -> None:
    """``nvcc -c`` every source at once, then link; each output is written
    under a name of this process's and renamed into place."""
    objs = [BUILD_DIR / f"{s.stem}-{digest}.o" for s in srcs]
    tmps = [o.with_suffix(f".{os.getpid()}.o") for o in objs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(t)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for s, t in zip(srcs, tmps)]
    errors = []
    for s, o, p in zip(srcs, objs, procs):
        out, _ = p.communicate()
        o.with_suffix(".log").write_text(out)     # ptxas: registers, spills
        if p.returncode:
            errors.append(f"{s.name}:\n{out}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    for t, o in zip(tmps, objs):
        os.replace(t, o)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *map(str, objs),
                           "-o", str(tmp)], capture_output=True, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, so)


def compile_log(so: Path, source: str) -> str:
    """What ``nvcc`` printed compiling ``source`` (a file name under some
    ``csrc/``) into the library ``so`` — with ``-Xptxas -v``, each kernel's
    registers, static shared memory and spills."""
    digest = so.stem.rsplit("-", 1)[1]
    return (so.parent / f"{Path(source).stem}-{digest}.log").read_text()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use (once, whichever
    threads ask for it first)."""
    global _lib
    if _lib is None:
        with _LIB_LOCK:
            if _lib is None:
                lib = ctypes.CDLL(str(build()))
                for name, argtypes in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _lib = lib
    return _lib


# where a wrapper's plain version stands in for its kernel (a tensor on the
# CPU, a fake one in the dry run), it runs through run_plain; the dry run's
# dispatch counter (roofline/dispatch.py) sets this hook to count the
# kernel's inputs and outputs in place of the plain version's ops
PLAIN_HOOK: Optional[Callable] = None


def run_plain(wrapper, fn, *args, **kwargs):
    """A kernel wrapper's CPU branch: ``fn(*args, **kwargs)``, its plain
    version, or ``PLAIN_HOOK(wrapper, fn, args, kwargs)`` where a hook is
    set."""
    if PLAIN_HOOK is None:
        return fn(*args, **kwargs)
    return PLAIN_HOOK(wrapper, fn, args, kwargs)


def count_launch(wrapper, kernel: Optional[str] = None) -> None:
    """Add one to ``wrapper.launches`` (and to its ``kernel_launches[kernel]``
    where it has several kernels), atomically."""
    with _COUNT_LOCK:
        wrapper.launches += 1
        if kernel is not None:
            wrapper.kernel_launches[kernel] += 1


def check_launch(name: str, rc: int) -> None:
    """Raise if a launcher reported a CUDA error (a refused launch never
    runs, and no later synchronise would report it)."""
    if rc:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


# element types the kernels take, by the code their C interface expects
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as the raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_no_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would need a gradient through ``tensors``: a kernel
    writes its output through a raw pointer, so the output would come back
    silently detached. A gradient goes through the autograd Function
    beside the wrapper, whose backward is a kernel too."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: its inputs need a gradient and the raw wrapper has no "
            "backward: use flash_attention.FlashAttention, "
            "rglru_scan.RGLRUScan or ssd_scan.SSDIntraChunk (which ssd_scan "
            "calls)")


def check_device(name: str, *tensors: torch.Tensor) -> str:
    """All ``tensors`` on one device, which is the CPU (plain version) or a
    CUDA device (the kernel); returns that device's type."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devices))}")
    kind = tensors[0].device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {tensors[0].device}")
    return kind
