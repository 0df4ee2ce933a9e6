"""RG-LRU recurrent block (Griffin / RecurrentGemma).

The port of ``repro/models/rglru.py``. Recurrence per channel:
``h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)`` with
``a_t = exp(−c·softplus(Λ)·r_t)``, ``r_t = σ(W_a x_t)``, ``i_t = σ(W_x x_t)``;
the gate projections are block-diagonal over ``lru_heads`` blocks. The
full-sequence path (:func:`rglru_mixer`) runs the recurrence through the
scan kernel (``repro_torch.kernels.rglru_scan``), and its gradient through
the scan's backward kernel (``RGLRUScan``); decode
(:func:`rglru_decode`) is the O(1) one-step update in plain torch, as the
JAX package's is jnp outside any kernel. Casts sit where the JAX package
puts them: projections and the convolution in the model dtype, gates and
state in fp32.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.rglru_scan import RGLRUScan
from .layers import causal_conv, dense_init, gelu_tanh

C_SCALE = 8.0
CONV_WIDTH = 4          # the causal convolution's taps; decode keeps 3 of them


class RGLRU(nn.Module):
    """``wx``/``wy`` (d, w), ``conv_w`` (4, w), ``gate_a``/``gate_i``
    (nb, blk, blk), ``out`` (w, d) in the model dtype; ``lam`` (w,) fp32,
    the deterministic Griffin init ``log(expm1(linspace(0.9, 4.0, w)))``."""

    def __init__(self, cfg, *, device, dtype, generator=None):
        super().__init__()
        d, w = cfg.d_model, cfg.resolved_lru_width
        nb = cfg.lru_heads or cfg.num_heads
        blk = w // nb
        shapes = {"wx": ((d, w), None), "wy": ((d, w), None),
                  "conv_w": ((CONV_WIDTH, w), 0.5),
                  "gate_a": ((nb, blk, blk), None),
                  "gate_i": ((nb, blk, blk), None), "out": ((w, d), None)}
        for name, (shape, scale) in shapes.items():
            t = (torch.empty(shape, device=device, dtype=dtype)
                 if generator is None else
                 dense_init(shape, generator=generator, device=device,
                            dtype=dtype, scale=scale))
            setattr(self, name, nn.Parameter(t, requires_grad=False))
        lam = torch.log(torch.expm1(torch.linspace(0.9, 4.0, w,
                                                   dtype=torch.float32)))
        self.lam = nn.Parameter(lam.to(device), requires_grad=False)


def _blockdiag(x: torch.Tensor, w_blocks: torch.Tensor) -> torch.Tensor:
    """x (B, S, w) times block-diagonal weights (nb, blk, blk) → (B, S, w)."""
    B, S, w = x.shape
    nb, blk, _ = w_blocks.shape
    xb = x.reshape(B, S, nb, blk)
    return torch.einsum("bsnk,nkj->bsnj", xb, w_blocks).reshape(B, S, w)


def _gates(p: RGLRU, xr: torch.Tensor):
    """Log-decay ``log_a`` (≤ 0) and input gate ``i``, both fp32, from the
    recurrence branch's activations."""
    r = torch.sigmoid(_blockdiag(xr, p.gate_a).float())
    i = torch.sigmoid(_blockdiag(xr, p.gate_i).float())
    log_a = -C_SCALE * F.softplus(p.lam) * r
    return log_a, i


def rglru_mixer(p: RGLRU, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence path (forward, prefill and training): x (B, S, d) →
    (B, S, d), the recurrence through the scan kernel (with its backward
    kernel where autograd needs the gradient)."""
    xr = x @ p.wx
    gate = gelu_tanh((x @ p.wy).float())
    xr = causal_conv(xr, p.conv_w.to(x.dtype))
    log_a, i = _gates(p, xr)
    x_in = i * xr.float()
    h = RGLRUScan.apply(x_in, log_a)
    y = (h * gate).to(x.dtype)
    return y @ p.out


def rglru_decode(p: RGLRU, x: torch.Tensor, h_prev: torch.Tensor,
                 conv_prev: torch.Tensor):
    """One step: x (B, 1, d), state ``h_prev`` (B, w) fp32 and the last
    ``CONV_WIDTH - 1`` inputs ``conv_prev`` (B, 3, w) in x's dtype →
    ``(y (B, 1, d), h (B, w), conv (B, 3, w))``."""
    xr = (x @ p.wx)[:, 0]
    gate = gelu_tanh((x @ p.wy)[:, 0].float())
    window = torch.cat([conv_prev, xr[:, None]], dim=1)          # (B, 4, w)
    conv = torch.einsum("bwc,wc->bc", window, p.conv_w.to(x.dtype))
    log_a, i = _gates(p, conv[:, None])
    log_a, i = log_a[:, 0], i[:, 0]
    a = torch.exp(log_a)
    x_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * conv.float())
    h = a * h_prev + x_in
    y = (h * gate).to(x.dtype)[:, None]
    return y @ p.out, h, window[:, 1:]
