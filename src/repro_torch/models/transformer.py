"""Block assembly: pre-norm ``attn``, ``sliding`` and ``rglru`` blocks, each
with its MLP.

The port of ``repro/models/transformer.py``. The JAX package scans over
pattern periods with period-stacked parameters and applies the remainder
layers after the scan; PyTorch runs eagerly, so the port keeps one module
per layer in an ``nn.ModuleList`` (the weight bridge splits the stacked
leaves), which covers the remainder layers as any other.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .attention import Attention, attention_decode, attention_train
from .layers import apply_mlp, apply_norm, dense_init
from .rglru import RGLRU, rglru_decode, rglru_mixer

ATTN_KINDS = ("attn", "sliding")
BLOCK_KINDS = ATTN_KINDS + ("rglru",)

NOT_PORTED = {
    "ssd": "ROADMAP Queue 1, item 14 (remaining architectures: mamba2)",
    "cross": "ROADMAP Queue 1, item 14 (remaining architectures: "
             "cross-attention)",
}


def check_block_kind(btype: str) -> None:
    if btype not in BLOCK_KINDS:
        raise NotImplementedError(
            f"block type {btype!r} is not ported yet: "
            f"{NOT_PORTED.get(btype, 'ROADMAP Queue 1')}")


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


class Block(nn.Module):
    """One block: norms in fp32, weights in the model dtype; the mixer is
    ``attn`` (attention kinds) or ``rglru``."""

    def __init__(self, cfg, btype: str, *, device, dtype, generator=None):
        super().__init__()
        check_block_kind(btype)
        if cfg.is_moe or not cfg.d_ff:
            raise NotImplementedError(
                "MoE / MLP-less blocks are not ported yet: ROADMAP Queue 1, "
                "item 14 (remaining architectures)")
        self.btype = btype
        ones = lambda: nn.Parameter(  # noqa: E731
            torch.ones(cfg.d_model, device=device, dtype=torch.float32),
            requires_grad=False)
        self.norm1 = ones()
        self.norm2 = ones()
        if btype in ATTN_KINDS:
            self.attn = Attention(cfg, device=device, dtype=dtype,
                                  generator=generator)
        else:
            self.rglru = RGLRU(cfg, device=device, dtype=dtype,
                               generator=generator)
        self.mlp = MLP(cfg, device=device, dtype=dtype, generator=generator)


def _window(p: Block, cfg) -> int:
    return cfg.sliding_window if p.btype == "sliding" else 0


def apply_block_train(p: Block, x: torch.Tensor, rope, cfg) -> torch.Tensor:
    h = apply_norm(p.norm1, x, cfg.norm)
    if p.btype == "rglru":
        x = x + rglru_mixer(p.rglru, h)
    else:
        x = x + attention_train(p.attn, h, rope, cfg, window=_window(p, cfg))
    h = apply_norm(p.norm2, x, cfg.norm)
    return x + apply_mlp(p.mlp, h, cfg.mlp_kind)


def apply_block_decode(p: Block, x: torch.Tensor, state: tuple,
                       pos: torch.Tensor, rope, cfg) -> torch.Tensor:
    """One token per batch row. ``state`` is the layer's cache, updated IN
    PLACE: ``(k_cache, v_cache, write_idx)`` for an attention block,
    ``(h, conv)`` views of the slot-major recurrent caches for ``rglru``."""
    h = apply_norm(p.norm1, x, cfg.norm)
    if p.btype == "rglru":
        h_state, conv_state = state
        y, h_new, conv_new = rglru_decode(p.rglru, h, h_state, conv_state)
        h_state.copy_(h_new)
        conv_state.copy_(conv_new)
        x = x + y
    else:
        k_cache, v_cache, write_idx = state
        x = x + attention_decode(p.attn, h, k_cache, v_cache, pos, rope,
                                 write_idx, cfg)
    h = apply_norm(p.norm2, x, cfg.norm)
    return x + apply_mlp(p.mlp, h, cfg.mlp_kind)
