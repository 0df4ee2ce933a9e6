"""Mamba-2 (SSD — state-space duality) mixer.

The port of ``repro/models/ssm.py``. Layout: x (B, S, H, P) heads, B/C
(B, S, G, N) groups (G | H), dt (B, S, H), A (H,). Recurrence per head:
``h_t = exp(dt_t A) h_{t-1} + dt_t B_t ⊗ x_t``, ``y_t = C_t · h_t + D x_t``.
The full-sequence path (:func:`mamba2_mixer`) runs the scan through the SSD
kernel (``repro_torch.kernels.ssd_scan``), and its gradient through the
SSD backward kernel (``SSDIntraChunk``, which ``ssd_scan`` takes under
autograd); decode (:func:`mamba2_decode`) is
the O(1) one-step state update in plain torch, as the JAX package's is jnp
outside any kernel. Casts sit where the JAX package puts them: projections
and the convolution in the model dtype; dt, A, the scan and the state in
fp32.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.ssd_scan import ssd_scan
from .layers import causal_conv, dense_init, rms_norm_vec, silu


def conv_dim(cfg) -> int:
    """Channels of the causal convolution: x, B and C side by side."""
    return cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state_dim


class Mamba2(nn.Module):
    """``in_x``/``in_z`` (d, d_inner), ``in_B``/``in_C`` (d, G·N), ``in_dt``
    (d, H), ``conv_w`` (width, conv_dim), ``out`` (d_inner, d) and
    ``norm_scale`` (d_inner,) in the model dtype; ``dt_bias``, ``A_log``
    (zeros: A = −1) and ``D`` (ones), each (H,), in fp32 — the leaves and
    init of the JAX package's ``init_mamba2``."""

    def __init__(self, cfg, *, device, dtype, generator=None):
        super().__init__()
        d, din, H = cfg.d_model, cfg.d_inner, cfg.ssm_nheads
        GN = cfg.ssm_ngroups * cfg.ssm_state_dim
        shapes = {"in_x": ((d, din), None), "in_z": ((d, din), None),
                  "in_B": ((d, GN), None), "in_C": ((d, GN), None),
                  "in_dt": ((d, H), None),
                  "conv_w": ((cfg.ssm_conv_width, conv_dim(cfg)), 0.5),
                  "out": ((din, d), None)}
        for name, (shape, scale) in shapes.items():
            t = (torch.empty(shape, device=device, dtype=dtype)
                 if generator is None else
                 dense_init(shape, generator=generator, device=device,
                            dtype=dtype, scale=scale))
            setattr(self, name, nn.Parameter(t, requires_grad=False))
        fixed = {"dt_bias": torch.zeros(H), "A_log": torch.zeros(H),
                 "D": torch.ones(H), "norm_scale": torch.ones(din, dtype=dtype)}
        for name, t in fixed.items():
            setattr(self, name, nn.Parameter(t.to(device), requires_grad=False))


def _project(p: Mamba2, x: torch.Tensor):
    """The input projections: the conv's input (x, B, C side by side), the
    gate z and the raw dt, all in x's dtype."""
    conv_in = torch.cat([x @ p.in_x, x @ p.in_B, x @ p.in_C], dim=-1)
    return conv_in, x @ p.in_z, x @ p.in_dt


def _split(conv_out: torch.Tensor, cfg):
    """(…, conv_dim) → x (…, H, P), B and C (…, G, N), each contiguous."""
    din, GN = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state_dim
    lead = conv_out.shape[:-1]
    xs = conv_out[..., :din].reshape(*lead, cfg.ssm_nheads, cfg.ssm_head_dim)
    Bv = conv_out[..., din:din + GN].reshape(*lead, cfg.ssm_ngroups, -1)
    Cv = conv_out[..., din + GN:].reshape(*lead, cfg.ssm_ngroups, -1)
    return xs.contiguous(), Bv.contiguous(), Cv.contiguous()


def _out(p: Mamba2, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Gated rms norm and the output projection: y, z (…, d_inner)."""
    return rms_norm_vec(y * silu(z), p.norm_scale) @ p.out


def mamba2_mixer(p: Mamba2, x: torch.Tensor, cfg) -> torch.Tensor:
    """Full-sequence path (forward, prefill and training): x (B, S, d) →
    (B, S, d), the scan through the SSD kernel (and its backward kernel
    where autograd needs the gradient). S must be below the chunk or a multiple
    of it, as in the JAX package."""
    B_, S, _ = x.shape
    conv_in, z, dt = _project(p, x)
    conv_out = silu(causal_conv(conv_in, p.conv_w.to(x.dtype)))
    xs, Bv, Cv = _split(conv_out, cfg)
    dt = F.softplus(dt.float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    y = ssd_scan(xs, dt, A, Bv, Cv, chunk=cfg.ssm_chunk)
    y = y + xs * p.D[None, None, :, None].to(x.dtype)
    return _out(p, y.reshape(B_, S, cfg.d_inner), z)


def mamba2_decode(p: Mamba2, x: torch.Tensor, ssm_prev: torch.Tensor,
                  conv_prev: torch.Tensor, cfg):
    """One step: x (B, 1, d), the state ``ssm_prev`` (B, H, P, N) fp32 and
    the last ``width - 1`` conv inputs ``conv_prev`` (B, width - 1,
    conv_dim) in x's dtype → ``(y (B, 1, d), ssm (B, H, P, N), conv)``."""
    B_ = x.shape[0]
    H = cfg.ssm_nheads
    conv_in, z, dt = _project(p, x)
    window = torch.cat([conv_prev, conv_in], dim=1)          # (B, width, c)
    conv = silu(torch.einsum("bwc,wc->bc", window, p.conv_w.to(x.dtype)))
    xs, Bv, Cv = _split(conv, cfg)
    rep = H // cfg.ssm_ngroups
    Bh = Bv.repeat_interleave(rep, dim=1).float()             # (B, H, N)
    Ch = Cv.repeat_interleave(rep, dim=1).float()
    dt1 = F.softplus(dt[:, 0].float() + p.dt_bias)            # (B, H)
    a = torch.exp(dt1 * -torch.exp(p.A_log))
    xf = xs.float()
    state = (ssm_prev * a[..., None, None]
             + (dt1[..., None] * xf)[..., :, None] * Bh[..., None, :])
    y = torch.einsum("bhpn,bhn->bhp", state, Ch) + xf * p.D[None, :, None]
    y = y.reshape(B_, 1, cfg.d_inner).to(x.dtype)
    return _out(p, y, z), state, window[:, 1:]
