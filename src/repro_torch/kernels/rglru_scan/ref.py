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


def rglru_scan_backward_ref(x_in: torch.Tensor, log_a: torch.Tensor,
                            h: torch.Tensor, dh: torch.Tensor):
    """The scan's vector-Jacobian product (the CPU path and the oracle the
    backward kernel is held against): from the inputs, the saved states
    ``h`` and the states' gradient ``dh``, all (B, S, W) fp32, →
    ``(dx_in, dlog_a)`` fp32, by a reverse loop over time with ``a =
    exp(log_a)``, ``s = sqrt(max(1 - a², 1e-12))``:

    - ``δ_t = dh_t + a_{t+1} δ_{t+1}`` (``δ_S = 0``), the state's adjoint;
    - ``dx_in_t = δ_t s_t``;
    - ``da_t = δ_t h_{t-1} - δ_t x_in_t a_t / s_t``, the second term only
      where ``1 - a_t² > 1e-12`` (``jax.grad`` of ``jnp.maximum`` against a
      constant is 0 where the constant wins);
    - ``dlog_a_t = da_t a_t``."""
    a = torch.exp(log_a.float())
    one_minus = 1.0 - a * a
    s = torch.sqrt(torch.clamp(one_minus, min=1e-12))
    ds = torch.where(one_minus > 1e-12, -a / s, 0.0)      # d s / d a
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    delta = torch.empty_like(a)
    g = torch.zeros_like(a[:, 0])              # a_{t+1} δ_{t+1}
    for t in range(a.shape[1] - 1, -1, -1):
        torch.add(dh[:, t].float(), g, out=delta[:, t])
        g = a[:, t] * delta[:, t]
    dx_in = delta * s
    da = delta * h_prev.float() + delta * x_in.float() * ds
    return dx_in, da * a
