"""Plain PyTorch version of the fault probe (the CPU path and the oracle the
CUDA kernel is held against)."""
from __future__ import annotations

import torch


def probe_rows_ref(x: torch.Tensor, threshold: float, *, nonfinite_code: int,
                   overflow_code: int) -> torch.Tensor:
    """One int32 word per row of ``x (R, N)``: ``nonfinite_code`` if the row
    holds a NaN/±inf, ``overflow_code`` if a finite value has
    ``|x| > threshold``."""
    xf = x.float()
    finite = torch.isfinite(xf)
    nonfinite = ~finite.all(dim=1)
    over = (torch.where(finite, xf.abs(), torch.zeros_like(xf))
            > threshold).any(dim=1)
    zero = torch.zeros((), dtype=torch.int32, device=x.device)
    return (torch.where(nonfinite, torch.full_like(zero, nonfinite_code), zero)
            | torch.where(over, torch.full_like(zero, overflow_code), zero))
