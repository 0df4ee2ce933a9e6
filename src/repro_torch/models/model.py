"""Top-level model: seeded init, full forward, slot decode, caches.

The port of ``repro/models/model.py`` for dense ``attn`` stacks (qwen3).
Parameters live in an ``nn.Module`` on an explicit device; caches are two
tensors ``k``/``v`` of shape ``(layers, batch, capacity, kv_heads,
head_dim)`` updated in place by :meth:`Model.decode_step`.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn as nn

from ..configs.base import ModelConfig
from .attention import cache_write_index
from .layers import apply_norm, dense_init, embed_tokens, rope_tables, unembed
from .transformer import (NOT_PORTED, Block, apply_block_decode,
                          apply_block_train)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Raises when that is CUDA and there is none — the port never
    drops to the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller "
            "passes device='cpu'")
    return dev


def pin_matmul_precision() -> None:
    """fp32 products in full fp32 on the card: TF32 off for cuBLAS and cuDNN.
    Every model build calls this — the one place the port sets it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class Model(nn.Module):
    """Dense decoder bound to a config, with its weights on ``device``.

    ``seed`` draws the weights with a ``torch.Generator`` on that device from
    the same distributions as the JAX package's init; ``seed=None`` leaves
    them uninitialised for the weight bridge
    (:func:`repro_torch.weights.params_from_jax`) to fill.
    """

    def __init__(self, cfg: ModelConfig, *, device=None,
                 seed: Optional[int] = 0):
        super().__init__()
        for b in cfg.pattern_layers:
            if b != "attn":
                raise NotImplementedError(
                    f"block type {b!r} is not ported yet: "
                    f"{NOT_PORTED.get(b, 'ROADMAP Queue 1')}")
        if not cfg.tie_embeddings:
            raise NotImplementedError(
                "untied unembedding is not ported yet: ROADMAP Queue 1, item "
                "14 (remaining architectures)")
        pin_matmul_precision()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = model_dtype(cfg)
        gen = None
        if seed is not None:
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
        shape = (cfg.vocab_size, cfg.d_model)
        emb = (torch.empty(shape, device=self.device, dtype=self.dtype)
               if gen is None else
               dense_init(shape, generator=gen, device=self.device,
                          dtype=self.dtype, scale=1.0))
        self.embed = nn.Parameter(emb, requires_grad=False)
        self.blocks = nn.ModuleList(
            Block(cfg, b, device=self.device, dtype=self.dtype, generator=gen)
            for b in cfg.pattern_layers)
        self.final_norm = nn.Parameter(
            torch.ones(cfg.d_model, device=self.device, dtype=torch.float32),
            requires_grad=False)
        self.tie_unembed()

    def tie_unembed(self) -> None:
        """(Re)make the fp32 copy of the tied embedding the unembedding reads.
        In bf16 it costs ``vocab * d_model * 4`` bytes once (1.24 GB at full
        qwen3 width) instead of that cast on every step; in fp32 it is the
        embedding itself."""
        self.embed_f32 = (self.embed.detach() if self.dtype == torch.float32
                          else self.embed.detach().float())

    # ------------------------------------------------------------------ forward
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence causal forward: tokens (B, S) → fp32 logits (B, S, V)."""
        cfg = self.cfg
        x = self._embed(tokens)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device,
                                 dtype=torch.int32).expand(B, S)
        rope = self._rope(positions)
        for blk in self.blocks:
            x = apply_block_train(blk, x, rope, cfg)
        x = apply_norm(self.final_norm, x, cfg.norm)
        return unembed(x, self.embed_f32, softcap=cfg.logit_softcap)

    # ------------------------------------------------------------------- decode
    def init_cache(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, device=self.device, dtype=self.dtype),
                "v": torch.zeros(shape, device=self.device, dtype=self.dtype)}

    def decode_step(self, token: torch.Tensor, cache: dict,
                    pos: Union[int, torch.Tensor]) -> torch.Tensor:
        """One new token per batch row against ``cache`` (updated in place).

        token (B, 1) int; pos an int (every row at that position, as the JAX
        package's scalar ``pos``) or an int32 (B,) tensor on the model's
        device (per-slot positions). Returns fp32 logits (B, 1, V).
        """
        cfg = self.cfg
        B = token.shape[0]
        if isinstance(pos, int):
            pos = torch.full((B,), pos, dtype=torch.int32, device=self.device)
        x = self._embed(token)
        # every layer rotates at, and writes its cache at, the same positions
        rope = self._rope(pos[:, None])
        write_idx = cache_write_index(pos, cache["k"].shape[2])
        for i, blk in enumerate(self.blocks):
            x = apply_block_decode(blk, x, cache["k"][i], cache["v"][i], pos,
                                   rope, write_idx, cfg)
        x = apply_norm(self.final_norm, x, cfg.norm)
        return unembed(x, self.embed_f32, softcap=cfg.logit_softcap)

    def _rope(self, positions: torch.Tensor):
        cfg = self.cfg
        return rope_tables(positions, head_dim=cfg.resolved_head_dim,
                           theta=cfg.rope_theta, style=cfg.rope_style)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = embed_tokens(self.embed, tokens, self.dtype)
        if self.cfg.embed_scale != 1.0:
            x = x * torch.tensor(self.cfg.embed_scale, dtype=self.dtype,
                                 device=x.device)
        return x
