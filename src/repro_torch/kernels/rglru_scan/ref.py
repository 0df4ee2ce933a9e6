"""Plain PyTorch version of the RG-LRU scan (the CPU path and the oracle the
CUDA kernel is held against): the gating prologue, then the sequential
recurrence one time step at a time."""
from __future__ import annotations

import torch


def rglru_scan_ref(x_in: torch.Tensor, log_a: torch.Tensor) -> torch.Tensor:
    """x_in (pre-gate input ``i ⊙ x``) and log_a (≤ 0), both (B, S, W) →
    h (B, S, W) fp32 with ``h_t = a_t h_{t-1} + sqrt(max(1 - a_t², 1e-12))
    x_in_t``, ``a = exp(log_a)``, ``h_0 = 0``."""
    a = torch.exp(log_a.float())
    x = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * x_in.float()
    out = torch.empty_like(x)
    h = torch.zeros_like(x[:, 0])
    for t in range(x.shape[1]):
        torch.addcmul(x[:, t], a[:, t], h, out=out[:, t])   # x + a * h
        h = out[:, t]
    return out
