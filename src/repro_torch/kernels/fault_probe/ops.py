"""Wrapper of the fault-probe kernel (``csrc/fault_probe.cu``).

A tensor on the CPU goes to the plain version (``ref.py``); a CUDA tensor
goes to the kernel or raises — there is no fallback.
"""
from __future__ import annotations

import torch

from ..build import (DTYPE_CODES, check_device, check_launch, count_launch,
                     library, stream_of)
from .ref import probe_rows_ref

MAX_ROWS = 2 ** 31 - 2 ** 16    # the kernel's row loop counts in int32


def probe_rows(x: torch.Tensor, threshold: float, *, nonfinite_code: int,
               overflow_code: int) -> torch.Tensor:
    """Error word per row of ``x (R, N)`` as an int32 ``(R,)`` tensor.

    Each word is what the TPU kernel ``probe_rows`` computes over that row's
    values; with ``R = 1`` it is the TPU kernel's word over the whole stream.
    Rows may hold more than 2^31 elements (the kernel indexes in 64 bits).
    """
    kind = check_device("probe_rows", x)
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"probe_rows: x must be (rows, cols), got {tuple(x.shape)}")
    if x.shape[0] > MAX_ROWS:
        raise ValueError(f"probe_rows: {x.shape[0]} rows exceed the kernel's "
                         f"{MAX_ROWS}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"probe_rows: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("probe_rows: x must be contiguous")
    for code in (nonfinite_code, overflow_code):
        if not 0 <= int(code) < 2 ** 31:
            raise ValueError(f"probe_rows: code {code} does not fit an int32 word")
    if kind == "cpu":
        return probe_rows_ref(x, threshold, nonfinite_code=nonfinite_code,
                              overflow_code=overflow_code)
    rows, cols = x.shape
    out = torch.zeros((rows,), dtype=torch.int32, device=x.device)
    rc = library().repro_probe_rows(
        x.data_ptr(), rows, cols, DTYPE_CODES[x.dtype], float(threshold),
        int(nonfinite_code), int(overflow_code), out.data_ptr(), stream_of(x))
    check_launch("probe_rows", rc)
    count_launch(probe_rows)
    return out


probe_rows.launches = 0
