"""Wrappers of the SSD intra-chunk kernels (``csrc/*.cu``), of their
backward (``csrc/ssd_chunk_bwd_tc.cu``, ``csrc/ssd_chunk_bwd.cu``) and of
the chunked scan around them;
:class:`SSDIntraChunk` is the forward and the backward as one autograd
Function, which :func:`ssd_scan` takes when a gradient is needed.

A tensor on the CPU goes to the plain version (``ref.py``); a CUDA tensor
goes to a kernel or raises — there is no fallback. :func:`plan` picks the
kernel from the dtype alone:

- ``ssd_chunk_tc`` (``csrc/ssd_chunk_tc.cu``): x, B, C in bf16, on the
  tensor cores (C·Bᵀ once per group, causal tiles only, the fp32 operands
  split into bf16 hi + lo);
- ``ssd_f32`` (``csrc/ssd_f32.cu``): fp32, on the CUDA cores (TF32 would not
  hold fp32 results to 1e-4).

The backward (``ssd_chunk_bwd``) has two as well, chosen by
:func:`plan_bwd` from the dtype alone:

- ``ssd_chunk_bwd_tc`` (``csrc/ssd_chunk_bwd_tc.cu``): x, B, C in bf16 (every
  train step's), on the tensor cores with the same hi + lo split;
- ``ssd_chunk_bwd_f32`` (``csrc/ssd_chunk_bwd.cu``): fp32, on the CUDA
  cores.
"""
from __future__ import annotations

import torch

from ..build import (DTYPE_CODES, check_device, check_launch, check_no_grad,
                     count_launch, library, run_plain, stream_of)
from .ref import (check_scan_shapes, ssd_inter_chunk,
                  ssd_intra_chunk_backward_ref, ssd_intra_chunk_ref)

MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 128   # the kernels' tiles
MAX_GRID = 65535                # batch and chunk count ride grid y and z
KERNELS = ("ssd_chunk_tc", "ssd_f32")
BWD_KERNELS = ("ssd_chunk_bwd_tc", "ssd_chunk_bwd_f32")


def plan(dtype: torch.dtype) -> str:
    """The kernel that x, B, C of this dtype take: a choice by dtype, not a
    fallback."""
    return "ssd_chunk_tc" if dtype == torch.bfloat16 else "ssd_f32"


def plan_bwd(dtype: torch.dtype) -> str:
    """The backward kernel that x, B, C of this dtype take, as :func:`plan`."""
    return "ssd_chunk_bwd_tc" if dtype == torch.bfloat16 else "ssd_chunk_bwd_f32"


def _check(kind: str, name: str, x, dt, A, B, C, chunk: int) -> int:
    """Shapes, dtypes and contiguity of the intra-chunk inputs, and on the
    card the kernels' limits; returns the chunk length L."""
    L = check_scan_shapes(x, dt, A, B, C, chunk)
    if x.dtype not in DTYPE_CODES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"{name}: x, B, C must share one of "
                        f"{list(DTYPE_CODES)}, got {x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"{name}: dt and A must be float32, got {dt.dtype} "
                        f"and {A.dtype}")
    if not all(t.is_contiguous() for t in (x, dt, A, B, C)):
        raise ValueError(f"{name}: inputs must be contiguous")
    if kind == "cuda":
        if x.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (x, B, C)):
            raise ValueError(f"{name}: x, B, C must be 16-byte aligned (the "
                             "kernels stage bf16 rows as 16-byte vectors)")
        b, s, _, p = x.shape
        if L > MAX_CHUNK or p > MAX_HEAD_DIM or B.shape[3] > MAX_STATE:
            raise ValueError(f"{name}: chunk {L}, head_dim {p} or state "
                             f"{B.shape[3]} exceeds the kernel's {MAX_CHUNK}, "
                             f"{MAX_HEAD_DIM}, {MAX_STATE}")
        if b > MAX_GRID or s // L > MAX_GRID:
            raise ValueError(f"{name}: batch {b} or {s // L} chunks exceed "
                             f"the grid's {MAX_GRID}")
    return L


def ssd_intra_chunk(x, dt, A, B, C, chunk: int):
    """The kernel's function over chunks of ``L = min(chunk, s)`` steps →
    ``(y_diag (b, s, h, p), states (b, s/L, h, p, n))``, both fp32: what the
    JAX package's ``ops.py`` prologue and its Pallas ``ssd_intra_chunk``
    compute together. x, B, C share one dtype (the model's); dt and A are
    fp32. The kernels' launches count on :func:`ssd_scan`, the wrapper the
    model calls (``launches``, and each kernel's in ``kernel_launches``)."""
    kind = check_device("ssd_scan", x, dt, A, B, C)
    check_no_grad("ssd_scan", x, dt, A, B, C)
    L = _check(kind, "ssd_scan", x, dt, A, B, C, chunk)
    if kind == "cpu":
        return run_plain(ssd_scan, ssd_intra_chunk_ref, x, dt, A, B, C, L)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    kernel = plan(x.dtype)
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    states = torch.empty((b, s // L, h, p, n), dtype=torch.float32,
                         device=x.device)
    rc = getattr(library(), f"repro_{kernel}")(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), states.data_ptr(), b, s, h, p, g, n, L, stream_of(x))
    check_launch(kernel, rc)
    count_launch(ssd_scan, kernel)
    return y, states


def ssd_chunk_bwd(x, dt, A, B, C, chunk: int, dy_diag, dstates):
    """The vector-Jacobian product of :func:`ssd_intra_chunk` over chunks
    of ``L = min(chunk, s)`` steps: its inputs and the gradients of its
    outputs, ``dy_diag`` (b, s, h, p) and ``dstates`` (b, s/L, h, p, n) fp32
    → ``(dx, ddt, dA, dB, dC)`` fp32 in the inputs' shapes, through the
    kernel :func:`plan_bwd` picks. The kernels give dB and dC per head and
    dA per (batch, chunk, head); they are summed here over the heads of
    each group and into A, in a fixed order (no atomics)."""
    kind = check_device("ssd_chunk_bwd", x, dt, A, B, C, dy_diag, dstates)
    L = _check(kind, "ssd_chunk_bwd", x, dt, A, B, C, chunk)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc = s // L
    if (tuple(dy_diag.shape) != (b, s, h, p)
            or tuple(dstates.shape) != (b, nc, h, p, n)):
        raise ValueError(f"ssd_chunk_bwd: dy_diag {tuple(dy_diag.shape)} and "
                         f"dstates {tuple(dstates.shape)} must be {(b, s, h, p)} "
                         f"and {(b, nc, h, p, n)}")
    if dy_diag.dtype != torch.float32 or dstates.dtype != torch.float32:
        raise TypeError("ssd_chunk_bwd: dy_diag and dstates must be float32")
    if not (dy_diag.is_contiguous() and dstates.is_contiguous()):
        raise ValueError("ssd_chunk_bwd: dy_diag and dstates must be contiguous")
    if kind == "cpu":
        return run_plain(ssd_chunk_bwd, ssd_intra_chunk_backward_ref, x, dt, A,
                         B, C, L, dy_diag, dstates)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, ddt = torch.empty((b, s, h, p), **f32), torch.empty((b, s, h), **f32)
    dA = torch.empty((b, nc, h), **f32)
    dB, dC = torch.empty((b, s, h, n), **f32), torch.empty((b, s, h, n), **f32)
    kernel = plan_bwd(x.dtype)
    rc = getattr(library(), f"repro_{kernel}")(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        dy_diag.data_ptr(), dstates.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
        dA.data_ptr(), dB.data_ptr(), dC.data_ptr(), b, s, h, p, g, n, L,
        stream_of(x))
    check_launch(kernel, rc)
    count_launch(ssd_chunk_bwd, kernel)
    per_group = (b, s, g, h // g, n)
    return (dx, ddt, dA.sum((0, 1)), dB.view(per_group).sum(3),
            dC.view(per_group).sum(3))


class SSDIntraChunk(torch.autograd.Function):
    """:func:`ssd_intra_chunk` with a gradient: ``SSDIntraChunk.apply(x,
    dt, A, B, C, chunk)`` → ``(y_diag, states)``. The forward is one
    :func:`ssd_intra_chunk` call (the kernel ``plan`` picks, counted on
    :func:`ssd_scan`) and saves its inputs; the backward one
    :func:`ssd_chunk_bwd` call (the kernel on a CUDA tensor, the plain
    version on the CPU; the kernel ``plan_bwd`` picks on the card), its x,
    B and C gradients cast to their dtype."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk: int):
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return ssd_intra_chunk(x, dt, A, B, C, chunk)

    @staticmethod
    def backward(ctx, dy_diag, dstates):
        x, dt, A, B, C = ctx.saved_tensors
        dx, ddt, dA, dB, dC = ssd_chunk_bwd(x, dt, A, B, C, ctx.chunk,
                                            dy_diag.contiguous(),
                                            dstates.contiguous())
        return dx.to(x.dtype), ddt, dA, dB.to(B.dtype), dC.to(C.dtype), None


def ssd_scan(x, dt, A, B, C, chunk: int = 128) -> torch.Tensor:
    """x (b, s, h, p), dt (b, s, h), A (h,), B and C (b, s, g, n) → y (b, s,
    h, p) in x's dtype: the contract of the JAX package's ``ops.py
    ssd_scan``. The intra-chunk part runs in the kernel, through
    :class:`SSDIntraChunk` (the same launch whether autograd needs its
    gradient or not); the recurrence over the ``s / L`` chunk states and
    the off-diagonal term stay in torch (autograd differentiates them), as
    they stay in jnp beside the TPU kernel."""
    y_diag, states = SSDIntraChunk.apply(x, dt, A, B, C, chunk)
    L = min(chunk, x.shape[1])
    return ssd_inter_chunk(y_diag, states, dt, A, C, L).to(x.dtype)


ssd_scan.launches = 0                 # wrapper calls that launched a kernel
ssd_scan.kernel_launches = dict.fromkeys(KERNELS, 0)
ssd_chunk_bwd.launches = 0            # calls that launched a backward kernel
ssd_chunk_bwd.kernel_launches = dict.fromkeys(BWD_KERNELS, 0)
