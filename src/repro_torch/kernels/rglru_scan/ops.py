"""Wrapper of the RG-LRU scan kernel (``csrc/rglru_scan.cu``), chunked over
time in chunks of ``CHUNK`` steps.

A tensor on the CPU goes to the plain version (``ref.py``); a CUDA tensor
goes to the kernel or raises — there is no fallback.
"""
from __future__ import annotations

import torch

from ..build import (check_device, check_launch, check_no_grad, count_launch,
                     library, stream_of)
from .ref import rglru_scan_ref

CHUNK = 128                     # steps per chunk, whatever the length


def rglru_scan(x_in: torch.Tensor, log_a: torch.Tensor) -> torch.Tensor:
    """x_in (pre-gate input ``i ⊙ x``), log_a (≤ 0): fp32 (B, S, W) → the
    RG-LRU states h (B, S, W) fp32 — what the JAX package's ``ops.py
    rglru_scan`` and its Pallas kernel compute together."""
    kind = check_device("rglru_scan", x_in, log_a)
    check_no_grad("rglru_scan", x_in, log_a)
    if x_in.dim() != 3 or log_a.shape != x_in.shape or 0 in x_in.shape:
        raise ValueError("rglru_scan: x_in and log_a must share one non-empty "
                         f"(B, S, W) shape, got {tuple(x_in.shape)} and "
                         f"{tuple(log_a.shape)}")
    if x_in.dtype != torch.float32 or log_a.dtype != torch.float32:
        raise TypeError(f"rglru_scan: float32 inputs expected, got {x_in.dtype} "
                        f"and {log_a.dtype}")
    if not (x_in.is_contiguous() and log_a.is_contiguous()):
        raise ValueError("rglru_scan: inputs must be contiguous")
    if kind == "cpu":
        return rglru_scan_ref(x_in, log_a)
    B, S, W = x_in.shape
    if B > 65535:
        raise ValueError(f"rglru_scan: batch {B} exceeds the grid's 65535")
    out = torch.empty_like(x_in)
    nc = -(-S // CHUNK)
    # each earlier chunk's decay product and end state
    agg = torch.empty(2 * B * (nc - 1) * W, dtype=torch.float32, device=x_in.device)
    rc = library().repro_rglru_scan(x_in.data_ptr(), log_a.data_ptr(),
                                    out.data_ptr(), agg.data_ptr(), B, S, W, CHUNK,
                                    stream_of(x_in))
    check_launch("rglru_scan", rc)
    count_launch(rglru_scan)
    return out


rglru_scan.launches = 0
