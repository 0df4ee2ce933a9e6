"""Wrapper of the SSD intra-chunk kernels (``csrc/*.cu``) and the chunked
scan around them.

A tensor on the CPU goes to the plain version (``ref.py``); a CUDA tensor
goes to a kernel or raises — there is no fallback. :func:`plan` picks the
kernel from the dtype alone:

- ``ssd_chunk_tc`` (``csrc/ssd_chunk_tc.cu``): x, B, C in bf16, on the
  tensor cores (C·Bᵀ once per group, causal tiles only, the fp32 operands
  split into bf16 hi + lo);
- ``ssd_f32`` (``csrc/ssd_f32.cu``): fp32, on the CUDA cores (TF32 would not
  hold fp32 results to 1e-4).
"""
from __future__ import annotations

import torch

from ..build import (DTYPE_CODES, check_device, check_launch, count_launch,
                     library, stream_of)
from .ref import check_scan_shapes, ssd_inter_chunk, ssd_intra_chunk_ref

MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 128   # the kernels' tiles
MAX_GRID = 65535                # batch and chunk count ride grid y and z
KERNELS = ("ssd_chunk_tc", "ssd_f32")


def plan(dtype: torch.dtype) -> str:
    """The kernel that x, B, C of this dtype take: a choice by dtype, not a
    fallback."""
    return "ssd_chunk_tc" if dtype == torch.bfloat16 else "ssd_f32"


def ssd_intra_chunk(x, dt, A, B, C, chunk: int):
    """The kernel's function over chunks of ``L = min(chunk, s)`` steps →
    ``(y_diag (b, s, h, p), states (b, s/L, h, p, n))``, both fp32: what the
    JAX package's ``ops.py`` prologue and its Pallas ``ssd_intra_chunk``
    compute together. x, B, C share one dtype (the model's); dt and A are
    fp32. The kernels' launches count on :func:`ssd_scan`, the wrapper the
    model calls (``launches``, and each kernel's in ``kernel_launches``)."""
    kind = check_device("ssd_scan", x, dt, A, B, C)
    L = check_scan_shapes(x, dt, A, B, C, chunk)
    if x.dtype not in DTYPE_CODES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_scan: x, B, C must share one of "
                        f"{list(DTYPE_CODES)}, got {x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan: dt and A must be float32, got {dt.dtype} "
                        f"and {A.dtype}")
    if not all(t.is_contiguous() for t in (x, dt, A, B, C)):
        raise ValueError("ssd_scan: inputs must be contiguous")
    if kind == "cpu":
        return ssd_intra_chunk_ref(x, dt, A, B, C, L)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if L > MAX_CHUNK or p > MAX_HEAD_DIM or n > MAX_STATE:
        raise ValueError(f"ssd_scan: chunk {L}, head_dim {p} or state {n} "
                         f"exceeds the kernel's {MAX_CHUNK}, {MAX_HEAD_DIM}, "
                         f"{MAX_STATE}")
    kernel = plan(x.dtype)
    if kernel == "ssd_chunk_tc" and any(t.data_ptr() % 16 for t in (x, B, C)):
        raise ValueError("ssd_scan: x, B, C must be 16-byte aligned (the "
                         "kernel stages rows as 16-byte vectors)")
    if b > MAX_GRID or s // L > MAX_GRID:
        raise ValueError(f"ssd_scan: batch {b} or {s // L} chunks exceed the "
                         f"grid's {MAX_GRID}")
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    states = torch.empty((b, s // L, h, p, n), dtype=torch.float32,
                         device=x.device)
    rc = getattr(library(), f"repro_{kernel}")(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), states.data_ptr(), b, s, h, p, g, n, L, stream_of(x))
    check_launch(kernel, rc)
    count_launch(ssd_scan, kernel)
    return y, states


def ssd_scan(x, dt, A, B, C, chunk: int = 128) -> torch.Tensor:
    """x (b, s, h, p), dt (b, s, h), A (h,), B and C (b, s, g, n) → y (b, s,
    h, p) in x's dtype: the contract of the JAX package's ``ops.py
    ssd_scan``. The intra-chunk part runs in the kernel; the recurrence over
    the ``s / L`` chunk states and the off-diagonal term stay in torch, as
    they stay in jnp beside the TPU kernel."""
    y_diag, states = ssd_intra_chunk(x, dt, A, B, C, chunk)
    L = min(chunk, x.shape[1])
    return ssd_inter_chunk(y_diag, states, dt, A, C, L).to(x.dtype)


ssd_scan.launches = 0                 # wrapper calls that launched a kernel
ssd_scan.kernel_launches = dict.fromkeys(KERNELS, 0)
