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
increment of.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
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
    # x_in, log_a, h_out, agg (scratch), B, S, W, T (chunk), stream
    "repro_rglru_scan": (_P, _P, _P, _P, _L, _L, _L, _L, _P),
    # x, dt, A, B, C, y, states, b, S, H, P, G, N, L, stream
    "repro_ssd_chunk_tc": (_P, _P, _P, _P, _P, _P, _P, _L, _L, _I, _I, _I, _I,
                           _I, _P),
    "repro_ssd_f32": (_P, _P, _P, _P, _P, _P, _P, _L, _L, _I, _I, _I, _I, _I,
                      _P),
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
    objs = [BUILD_DIR / f"{s.stem}-{digest.hexdigest()[:16]}.o" for s in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for s, o in zip(srcs, objs)]
    errors = []
    for s, o, p in zip(srcs, objs, procs):
        out, _ = p.communicate()
        o.with_suffix(".log").write_text(out)     # ptxas: registers, spills
        if p.returncode:
            errors.append(f"{s.name}:\n{out}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *map(str, objs),
                           "-o", str(tmp)], capture_output=True, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, so)
    return so


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
    silently detached. The attention gradient goes through
    ``flash_attention.FlashAttention``; the scans have none yet."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: its inputs need a gradient and the kernel has no "
            "backward (attention: use FlashAttention; the RG-LRU and SSD "
            "scans: ROADMAP Queue 1, item 13, their training paths)")


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
