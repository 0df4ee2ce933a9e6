"""Common layers: rms and layer norms, rotary embeddings (half-split and
partial interleaved-pair), gated and plain MLPs, the causal depthwise
convolution, embeddings and the unembedding.

The port of ``repro/models/layers.py`` for the qwen3, qwen3-moe, gemma3,
recurrentgemma, mamba2, starcoder2, chatglm3 and phi3.5-moe paths. Each
function keeps the JAX package's arithmetic and dtype casts (norm and rope
in fp32, cast back to the activation dtype; logits in fp32), so the two
packages agree to float tolerance on the same weights.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint


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
               eps: float = 1e-6, *, bias: torch.Tensor | None = None
               ) -> torch.Tensor:
    """Pre-norm of the residual stream: ``rmsnorm``, or ``layernorm`` with
    its ``bias`` — in fp32, ``(x - mean) * rsqrt(var + eps) * scale + bias``
    with ``var`` the mean of the squared centred values (``jnp.var``'s
    route), cast back to x's dtype."""
    if kind == "rmsnorm":
        return rms_norm_vec(x, scale, eps)
    if kind != "layernorm":
        raise ValueError(f"unknown norm {kind!r} (rmsnorm or layernorm)")
    xf = x.float()
    centred = xf - xf.mean(dim=-1, keepdim=True)
    var = centred.square().mean(dim=-1, keepdim=True)
    out = centred * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def rms_norm_vec(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis with an explicit scale vector."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


class Rope(NamedTuple):
    """Rotary tables at a step's positions: fp32 ``cos``/``sin`` ``(B, S, 1,
    rot_dim/2)``, and how they rotate — ``standard`` (half-split over the
    whole head) or ``partial2d`` (interleaved pairs over the first
    ``rot_dim`` dims, the rest passed through)."""
    cos: torch.Tensor
    sin: torch.Tensor
    style: str
    rot_dim: int


def rope_tables(positions: torch.Tensor, *, head_dim: int, theta: float,
                style: str = "standard", fraction: float = 1.0):
    """The :class:`Rope` for positions (B, S) — or None for
    ``style="none"``. ``partial2d`` rotates ``int(head_dim * fraction) // 2
    * 2`` dims (chatglm: half the head), ``standard`` the whole head, each
    with ``inv = 1 / theta ** (arange(0, rot, 2) / rot)``. Every layer
    rotates at the same positions, so a step computes the tables once for
    all layers."""
    if style == "none":
        return None
    if style not in ("standard", "partial2d"):
        raise ValueError(f"unknown rope style {style!r}")
    rot = int(head_dim * (fraction if style == "partial2d" else 1.0)) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32,
                        device=positions.device) / rot
    ang = positions.float()[..., None] * (1.0 / (theta ** exps))
    return Rope(torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :],
                style, rot)


def apply_rope(x: torch.Tensor, rope) -> torch.Tensor:
    """x (B, S, H, D) rotated by ``rope = rope_tables(...)`` in fp32 and
    cast back, as the JAX package's ``apply_rope``: ``standard`` rotates the
    halves ``(x1, x2)``; ``partial2d`` the pairs ``(0, 1), (2, 3), ...`` of
    the first ``rot_dim`` dims, leaving the others' bits untouched."""
    if rope is None:
        return x
    cos, sin = rope.cos, rope.sin
    if rope.style == "standard":
        x1, x2 = x.float().chunk(2, dim=-1)
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        return out.to(x.dtype)
    xr = x[..., :rope.rot_dim].float().unflatten(-1, (-1, 2))
    r1, r2 = xr[..., 0], xr[..., 1]
    rot = torch.stack([r1 * cos - r2 * sin, r2 * cos + r1 * sin], dim=-1)
    return torch.cat([rot.flatten(-2).to(x.dtype), x[..., rope.rot_dim:]], dim=-1)


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


class EmbedLookup(torch.autograd.Function):
    """``embedding`` rows for ``tokens`` as the JAX package's ``jnp.take``
    gives them in training: ids in ``[-V, V)`` wrap (-1 is the last row),
    any other id gives a row of NaN (``mode="fill"``) — so no id outside the
    table ever reaches a CUDA gather (a device-side assert there would end
    the CUDA context).

    Its backward sums each id's rows without atomics: the ids are sorted
    (stable), each run of equal ids summed in order by ``segment_reduce``
    (in fp32; float64 for float64), and each sum written to its row once;
    rows of invalid ids go to a sink row that is dropped. ``index_add_``
    would add the rows with
    atomics on the card, in an order that changes from run to run, and
    replays would not be bit-exact. The shapes are fixed by the number of
    tokens: no host sync."""

    @staticmethod
    def forward(ctx, embedding: torch.Tensor, tokens: torch.Tensor):
        V = embedding.shape[0]
        t = tokens.long()
        valid = (t >= -V) & (t < V)
        idx = torch.where(valid, torch.remainder(t, V), 0)
        ctx.save_for_backward(torch.where(valid, idx, V))
        ctx.table = (V, embedding.dtype)
        return embedding[idx].masked_fill(~valid[..., None], float("nan"))

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (key,), (V, dtype) = ctx.saved_tensors, ctx.table
        key = key.reshape(-1)
        n, d = key.numel(), grad.shape[-1]
        order = torch.sort(key, stable=True).indices
        skey = key[order]
        acc = torch.promote_types(grad.dtype, torch.float32)
        rows = grad.reshape(n, d)[order].to(acc)
        start = torch.ones_like(skey, dtype=torch.bool)
        start[1:] = skey[1:] != skey[:-1]
        seg = torch.cumsum(start, dim=0) - 1                # run of each row
        lengths = torch.zeros_like(skey).scatter_add_(0, seg, torch.ones_like(skey))
        sums = torch.segment_reduce(rows, "sum", lengths=lengths, axis=0,
                                    unsafe=True)            # (n, d), empty runs 0
        ids = torch.full_like(skey, V).scatter_(0, seg, skey)
        out = torch.zeros((V + 1, d), dtype=acc, device=grad.device)
        out[ids] = sums                                     # unique ids < V
        return out[:V].to(dtype), None


def embed_lookup(embedding: torch.Tensor, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """The training embedding: :class:`EmbedLookup`, cast to ``dtype``."""
    return EmbedLookup.apply(embedding, tokens).to(dtype)


def unembed(x: torch.Tensor, w_f32: torch.Tensor, *,
            softcap: float = 0.0) -> torch.Tensor:
    """fp32 logits ``x @ w_f32``: ``w_f32`` (d, V) is the tied embedding's
    transpose or the untied ``unembed`` kernel, in fp32. Serving passes the
    fp32 copy the model keeps (made once, instead of a full-vocab cast every
    step: the same arithmetic as the JAX package's per-call cast)."""
    logits = x.float() @ w_f32
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token CE; logits fp32 (batch, seq, vocab), labels (batch,
    seq); with ``mask``, the mean over the masked-in tokens."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels.long()[..., None], dim=-1)[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def chunked_cross_entropy(x: torch.Tensor, labels: torch.Tensor, unembed_fn,
                          chunk: int) -> torch.Tensor:
    """The mean CE without the whole (B, S, V) fp32 logits: the sequence
    split into chunks of ``chunk`` positions (the last padded with zero
    rows that count for nothing), each chunk's logits ``unembed_fn(x_chunk)``
    and its summed NLL under a non-reentrant checkpoint (the backward
    recomputes the logits), the sums added in chunk order and divided by
    ``B * S``, as the JAX package's scan. ``unembed_fn`` may close over
    tensors: the recompute runs it again on the same ones."""
    B, S, d = x.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    valid = torch.ones((B, S), dtype=torch.float32, device=x.device)
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        valid = F.pad(valid, (0, pad))

    def chunk_nll(xch, lch, vch):
        logits = unembed_fn(xch)                   # (B, chunk, V) fp32
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, lch.long()[..., None], dim=-1)[..., 0]
        return torch.sum((logz - gold) * vch)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, S + pad, chunk):
        total = total + torch.utils.checkpoint.checkpoint(
            chunk_nll, x[:, c:c + chunk], labels[:, c:c + chunk],
            valid[:, c:c + chunk], use_reentrant=False)
    return total / (B * S)
