"""Block assembly: pre-norm (rms or layer norm) ``attn``, ``sliding``,
``cross`` and ``rglru`` blocks, each with its MLP or, for an MoE config,
its Mixture-of-Experts FFN, and ``ssd`` blocks, whose Mamba-2 mixer is the
whole block. A ``cross`` block (the VLM's image layers) attends the image
embeddings and scales its attention and its MLP output each by the tanh of
a 0-d fp32 gate (seeded 0, as the JAX package's), cast to the model dtype.

The port of ``repro/models/transformer.py``. The JAX package scans over
pattern periods with period-stacked parameters and applies the remainder
layers after the scan; PyTorch runs eagerly, so the port keeps one module
per layer in an ``nn.ModuleList`` (the weight bridge splits the stacked
leaves), which covers the remainder layers as any other.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .attention import (Attention, attention_decode, attention_train,
                        attention_verify, cross_attention_decode)
from .layers import apply_mlp, apply_norm, dense_init
from .moe import MoE, apply_moe
from .rglru import RGLRU, rglru_decode, rglru_mixer
from .ssm import Mamba2, mamba2_decode, mamba2_mixer

ATTN_KINDS = ("attn", "sliding", "cross")
# recurrent block kinds, each with the name of its state leaf in the cache
RECURRENT_STATE = {"rglru": "h", "ssd": "ssm"}
BLOCK_KINDS = ATTN_KINDS + tuple(RECURRENT_STATE)
MLP_BLOCKS = ATTN_KINDS + ("rglru",)    # blocks with norm2 and an MLP or MoE
GATES = ("gate_attn", "gate_mlp")       # a cross block's 0-d fp32 gates


def check_block_kind(btype: str) -> None:
    if btype not in BLOCK_KINDS:
        raise ValueError(f"unknown block type {btype!r}")


class MLP(nn.Module):
    """``wi`` (d, ff), ``wo`` (ff, d) and, for the gated kinds, ``wg``."""

    def __init__(self, cfg, *, device, dtype, generator=None):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        shapes = [("wi", (d, ff)), ("wo", (ff, d))]
        if cfg.mlp_kind in ("swiglu", "geglu"):
            shapes.append(("wg", (d, ff)))
        for name, shape in shapes:
            w = (torch.empty(shape, device=device, dtype=dtype)
                 if generator is None else
                 dense_init(shape, generator=generator, device=device,
                            dtype=dtype))
            setattr(self, name, nn.Parameter(w, requires_grad=False))


def norm_params(cfg, device) -> tuple:
    """A pre-norm's fp32 ``(scale, bias)`` parameters: ones, and for a
    ``layernorm`` config zeros (None otherwise). Neither draws from the
    generator, as in the JAX package's ``init_norm``."""
    param = lambda fill: nn.Parameter(  # noqa: E731
        torch.full((cfg.d_model,), fill, device=device, dtype=torch.float32),
        requires_grad=False)
    return param(1.0), (param(0.0) if cfg.norm == "layernorm" else None)


class Block(nn.Module):
    """One block: norms in fp32, weights in the model dtype; the mixer is
    ``attn`` (attention kinds), ``rglru`` or ``ssd``, the FFN ``mlp`` or,
    for an MoE config, ``moe`` (the other None). A ``layernorm`` config's
    norms carry ``norm1_bias``/``norm2_bias`` (None for ``rmsnorm``). An
    ``ssd`` block has no ``norm2`` and no FFN (all None), as in the JAX
    package. A config with ``d_ff`` 0 and no MoE builds ``norm2`` and no
    FFN: the block adds zeros in its place, as the JAX package's does. A
    ``cross`` block adds ``gate_attn`` and ``gate_mlp``, 0-d fp32 zeros
    (None elsewhere)."""

    def __init__(self, cfg, btype: str, *, device, dtype, generator=None):
        super().__init__()
        check_block_kind(btype)
        has_mlp = btype in MLP_BLOCKS
        self.btype = btype
        self.norm1, self.norm1_bias = norm_params(cfg, device)
        kw = dict(device=device, dtype=dtype, generator=generator)
        if btype == "rglru":
            self.rglru = RGLRU(cfg, **kw)
        elif btype == "ssd":
            self.ssd = Mamba2(cfg, **kw)
        else:
            self.attn = Attention(cfg, **kw)
        self.norm2, self.norm2_bias = (norm_params(cfg, device) if has_mlp
                                       else (None, None))
        self.mlp = (MLP(cfg, **kw) if has_mlp and cfg.d_ff and not cfg.is_moe
                    else None)
        self.moe = MoE(cfg, **kw) if has_mlp and cfg.is_moe else None
        for name in GATES:
            setattr(self, name, nn.Parameter(
                torch.zeros((), device=device, dtype=torch.float32),
                requires_grad=False) if btype == "cross" else None)


def _window(p: Block, cfg) -> int:
    return cfg.sliding_window if p.btype == "sliding" else 0


def _ffn(p: Block, h: torch.Tensor, cfg, with_aux: bool):
    """The MLP or MoE sub-block: ``(out, dropped_fraction)``, the fraction a
    0-d fp32 tensor for MoE with ``with_aux``, else None (the MLP drops
    nothing); zeros for a block with neither (``d_ff`` 0)."""
    if p.moe is not None:
        out, aux = apply_moe(p.moe, h, cfg, with_aux=with_aux)
        return out, (aux["dropped_fraction"] if with_aux else None)
    if p.mlp is None:
        return torch.zeros_like(h), None
    return apply_mlp(p.mlp, h, cfg.mlp_kind), None


def _gated(out: torch.Tensor, gate: Optional[torch.Tensor]) -> torch.Tensor:
    """A cross block's ``out * tanh(gate)``, the tanh in fp32 cast to
    ``out``'s dtype first, as the JAX package rounds it; ``out`` itself
    elsewhere (``gate`` None)."""
    return out if gate is None else out * torch.tanh(gate).to(out.dtype)


def _mlp(p: Block, x: torch.Tensor, cfg, with_aux: bool = False):
    """The residual FFN half of a block: ``(x, dropped_fraction)`` (see
    :func:`_ffn`; None for a block without an FFN)."""
    if p.norm2 is None:
        return x, None
    h = apply_norm(p.norm2, x, cfg.norm, bias=p.norm2_bias)
    out, drop = _ffn(p, h, cfg, with_aux)
    return x + _gated(out, p.gate_mlp), drop


def apply_block_train(p: Block, x: torch.Tensor, rope, cfg,
                      img_embeds: Optional[torch.Tensor] = None):
    """The full-sequence block: ``(x, dropped_fraction)``, the fraction None
    but for an MoE block. A ``cross`` block attends ``img_embeds``; without
    them it runs as causal self-attention with the rotary, gated, as the
    JAX package's does."""
    h = apply_norm(p.norm1, x, cfg.norm, bias=p.norm1_bias)
    if p.btype == "rglru":
        x = x + rglru_mixer(p.rglru, h)
    elif p.btype == "ssd":
        x = x + mamba2_mixer(p.ssd, h, cfg)
    else:
        kv_src = img_embeds if p.btype == "cross" else None
        a = attention_train(p.attn, h, rope, cfg, window=_window(p, cfg),
                            kv_src=kv_src)
        x = x + _gated(a, p.gate_attn)
    return _mlp(p, x, cfg, with_aux=True)


def apply_block_decode(p: Block, x: torch.Tensor, state: tuple,
                       pos: torch.Tensor, rope, cfg) -> torch.Tensor:
    """One token per batch row. ``state`` is the layer's cache, updated IN
    PLACE: ``(k_cache, v_cache, write_idx)`` for a self-attention block,
    ``(k, v, zeros)`` for a ``cross`` block (its image K/V, read only, and
    the (B,) int32 zeros of its ``q_offset``), ``(state, conv)`` views of
    the slot-major recurrent caches (``h`` for ``rglru``, ``ssm`` for
    ``ssd``). An MoE block's dropped fraction is
    ignored, as the JAX package's decode ignores it: at one token a row, K
    distinct experts of capacity 8 never drop."""
    h = apply_norm(p.norm1, x, cfg.norm, bias=p.norm1_bias)
    if p.btype in RECURRENT_STATE:
        rec_state, conv_state = state
        if p.btype == "rglru":
            y, rec_new, conv_new = rglru_decode(p.rglru, h, rec_state,
                                                conv_state)
        else:
            y, rec_new, conv_new = mamba2_decode(p.ssd, h, rec_state,
                                                 conv_state, cfg)
        rec_state.copy_(rec_new)
        conv_state.copy_(conv_new)
        x = x + y
    elif p.btype == "cross":
        x = x + _gated(cross_attention_decode(p.attn, h, *state, cfg),
                       p.gate_attn)
    else:
        k_cache, v_cache, write_idx = state
        x = x + attention_decode(p.attn, h, k_cache, v_cache, pos, rope,
                                 write_idx, cfg)
    return _mlp(p, x, cfg)[0]


def apply_block_verify(p: Block, xs: list, state: tuple, pos: torch.Tensor,
                       ropes: list, cfg) -> list:
    """The speculative verify through one block: ``xs`` holds row t's input
    ``(B, 1, d)`` for each t, at position ``pos + t``; ``state`` the layer's
    ``(k_cache, v_cache)``, written IN PLACE. Each row's norms and MLP run at
    the decode step's shape (see :func:`~repro_torch.models.attention.
    attention_verify`). Full attention only: a ring or a recurrent state
    advances destructively and cannot take the writes a rejected draft
    leaves behind."""
    if p.btype != "attn":
        raise ValueError("speculative verify supports full-attention blocks "
                         f"only, got {p.btype!r}")
    k_cache, v_cache = state
    hs = [apply_norm(p.norm1, x, cfg.norm, bias=p.norm1_bias) for x in xs]
    attn = attention_verify(p.attn, hs, k_cache, v_cache, pos, ropes, cfg)
    return [_mlp(p, x + a, cfg)[0] for x, a in zip(xs, attn)]
