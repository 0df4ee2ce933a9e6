"""Block assembly for the dense path: pre-norm ``attn`` blocks + SwiGLU.

The port of ``repro/models/transformer.py`` for ``attn`` blocks. The JAX
package scans over pattern periods with period-stacked parameters; PyTorch
runs eagerly, so the port keeps one module per layer in an
``nn.ModuleList`` (the weight bridge splits the stacked leaves).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .attention import Attention, attention_decode, attention_train
from .layers import apply_mlp, apply_norm, dense_init

NOT_PORTED = {
    "sliding": "ROADMAP Queue 1, item 6 (sliding-window and recurrent "
               "architectures in serving)",
    "rglru": "ROADMAP Queue 1, item 6 (sliding-window and recurrent "
             "architectures in serving)",
    "ssd": "ROADMAP Queue 1, item 14 (remaining architectures: mamba2)",
    "cross": "ROADMAP Queue 1, item 14 (remaining architectures: "
             "cross-attention)",
}


class MLP(nn.Module):
    def __init__(self, cfg, *, device, dtype, generator=None):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        for name, shape in (("wi", (d, ff)), ("wg", (d, ff)), ("wo", (ff, d))):
            w = (torch.empty(shape, device=device, dtype=dtype)
                 if generator is None else
                 dense_init(shape, generator=generator, device=device,
                            dtype=dtype))
            setattr(self, name, nn.Parameter(w, requires_grad=False))


class Block(nn.Module):
    """One ``attn`` block: norms in fp32, weights in the model dtype."""

    def __init__(self, cfg, btype: str, *, device, dtype, generator=None):
        super().__init__()
        if btype != "attn":
            raise NotImplementedError(
                f"block type {btype!r} is not ported yet: "
                f"{NOT_PORTED.get(btype, 'ROADMAP Queue 1')}")
        if cfg.is_moe or not cfg.d_ff:
            raise NotImplementedError(
                "MoE / MLP-less blocks are not ported yet: ROADMAP Queue 1, "
                "item 14 (remaining architectures)")
        ones = lambda: nn.Parameter(  # noqa: E731
            torch.ones(cfg.d_model, device=device, dtype=torch.float32),
            requires_grad=False)
        self.norm1 = ones()
        self.norm2 = ones()
        self.attn = Attention(cfg, device=device, dtype=dtype,
                              generator=generator)
        self.mlp = MLP(cfg, device=device, dtype=dtype, generator=generator)


def apply_block_train(p: Block, x: torch.Tensor, rope, cfg) -> torch.Tensor:
    h = apply_norm(p.norm1, x, cfg.norm)
    x = x + attention_train(p.attn, h, rope, cfg)
    h = apply_norm(p.norm2, x, cfg.norm)
    return x + apply_mlp(p.mlp, h, cfg.mlp_kind)


def apply_block_decode(p: Block, x: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, pos: torch.Tensor, rope,
                       write_idx, cfg) -> torch.Tensor:
    h = apply_norm(p.norm1, x, cfg.norm)
    x = x + attention_decode(p.attn, h, k_cache, v_cache, pos, rope,
                             write_idx, cfg)
    h = apply_norm(p.norm2, x, cfg.norm)
    return x + apply_mlp(p.mlp, h, cfg.mlp_kind)
