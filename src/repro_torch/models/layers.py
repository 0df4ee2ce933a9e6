"""Common layers: rms norm, rotary embeddings, gated and plain MLPs, the
causal depthwise convolution, embeddings.

The port of ``repro/models/layers.py`` for the qwen3, recurrentgemma and
mamba2 paths. Each function keeps the JAX package's arithmetic and dtype casts
(norm and rope in fp32, cast back to the activation dtype; logits in fp32),
so the two packages agree to float tolerance on the same weights.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F


def dense_init(shape, *, generator: torch.Generator, device, dtype,
               scale: float | None = None) -> torch.Tensor:
    """Normal draw times ``scale`` (default ``1/sqrt(fan_in)``), made in fp32
    and cast — the same distribution as the JAX package's ``_dense_init``
    (the numbers differ: another generator)."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def apply_norm(scale: torch.Tensor, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    """Pre-norm of the residual stream (rmsnorm only in this slice)."""
    if kind != "rmsnorm":
        raise NotImplementedError(
            f"norm {kind!r}: the port has rmsnorm only (ROADMAP Queue 1, "
            "item 14: remaining architectures)")
    return rms_norm_vec(x, scale, eps)


def rms_norm_vec(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis with an explicit scale vector."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_tables(positions: torch.Tensor, *, head_dim: int, theta: float,
                style: str = "standard"):
    """``(cos, sin)``, each fp32 ``(B, S, 1, head_dim/2)``, for positions
    (B, S) — or None for ``style="none"``. Every layer rotates at the same
    positions, so a step computes the tables once for all layers."""
    if style == "none":
        return None
    if style != "standard":
        raise NotImplementedError(
            f"rope style {style!r}: the port has 'standard' only (ROADMAP "
            "Queue 1, item 14: remaining architectures)")
    rot = head_dim // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32,
                        device=positions.device) / rot
    ang = positions.float()[..., None] * (1.0 / (theta ** exps))
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x: torch.Tensor, rope) -> torch.Tensor:
    """x (B, S, H, D) rotated by ``rope = rope_tables(...)`` (half-split
    rotation in fp32, the JAX package's ``standard`` style)."""
    if rope is None:
        return x
    cos, sin = rope
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


MLP_KINDS = ("swiglu", "geglu", "gelu")


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x / (1 + exp(-x))`` as ``jax.nn.silu`` lowers it: each of the four
    steps rounded to x's dtype. ``F.silu`` rounds once, so in bf16 it is up
    to 2 ulps from the JAX package's on most elements; this puts the bf16
    roundings where the reference's are."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh-approximate GELU spelled op for op as
    ``jax.nn.gelu(approximate=True)`` lowers it, each step rounded to x's
    dtype: ``cdf = 0.5 (1 + tanh(c (x + 0.044715 x^3)))``, then ``x cdf``.
    The constants are rounded to x's dtype first, as JAX rounds them, and
    ``x^3`` is two products each rounded (``F.gelu`` rounds once)."""
    c, a = _rounded(math.sqrt(2 / math.pi), x.dtype), _rounded(0.044715, x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + a * (x * x * x))))
    return x * cdf


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float (a scalar operand,
    so no tensor is made on the device per call)."""
    return torch.tensor(value, dtype=dtype).item()


def apply_mlp(p, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    """SwiGLU ``(silu(x wg) * (x wi)) wo``, GeGLU ``(gelu(x wg) * (x wi))
    wo``, or plain ``gelu(x wi) wo``; ``p`` has ``wi``, ``wo`` and, for the
    gated kinds, ``wg``."""
    h = x @ p.wi
    if kind == "swiglu":
        h = silu(x @ p.wg) * h
    elif kind == "geglu":
        h = gelu_tanh(x @ p.wg) * h
    elif kind == "gelu":
        h = gelu_tanh(h)
    else:
        raise ValueError(f"unknown mlp kind {kind!r} (one of {MLP_KINDS})")
    return h @ p.wo


def causal_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Causal depthwise convolution over time: u (B, S, c), w (taps, c)."""
    taps, S = w.shape[0], u.shape[1]
    up = F.pad(u, (0, 0, taps - 1, 0))
    out = torch.zeros_like(u)
    for i in range(taps):
        out = out + up[:, i:i + S] * w[i]
    return out


def embed_tokens(embedding: torch.Tensor, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    return embedding[tokens].to(dtype)


def unembed(x: torch.Tensor, embed_f32: torch.Tensor, *,
            softcap: float = 0.0) -> torch.Tensor:
    """fp32 logits against the tied embedding. ``embed_f32`` is the fp32
    copy the model keeps (made once, instead of a full-vocab cast every
    step: the same arithmetic as the JAX package's per-call cast)."""
    logits = x.float() @ embed_f32.t()
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    return logits
