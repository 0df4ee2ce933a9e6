# Copy of repro/configs/registry.py: every architecture, the cell table, the smoke configs.
"""Architecture registry: full configs, reduced smoke configs, cell applicability."""
from __future__ import annotations

import math
from typing import Optional

from .base import SHAPES, ModelConfig, ShapeConfig
from .chatglm3_6b import CONFIG as chatglm3_6b
from .gemma3_1b import CONFIG as gemma3_1b
from .hubert_xlarge import CONFIG as hubert_xlarge
from .llama32_vision_11b import CONFIG as llama32_vision_11b
from .mamba2_2_7b import CONFIG as mamba2_2_7b
from .phi35_moe_42b_a6_6b import CONFIG as phi35_moe
from .qwen3_1_7b import CONFIG as qwen3_1_7b
from .qwen3_moe_30b_a3b import CONFIG as qwen3_moe
from .recurrentgemma_2b import CONFIG as recurrentgemma_2b
from .starcoder2_3b import CONFIG as starcoder2_3b

ARCHS: dict[str, ModelConfig] = {
    "qwen3-moe-30b-a3b": qwen3_moe,
    "phi3.5-moe-42b-a6.6b": phi35_moe,
    "llama-3.2-vision-11b": llama32_vision_11b,
    "starcoder2-3b": starcoder2_3b,
    "qwen3-1.7b": qwen3_1_7b,
    "chatglm3-6b": chatglm3_6b,
    "gemma3-1b": gemma3_1b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "mamba2-2.7b": mamba2_2_7b,
    "hubert-xlarge": hubert_xlarge,
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


# ------------------------------------------------------------- cell applicability
def cell_skip_reason(arch: str, shape: str) -> Optional[str]:
    """None if the (arch, shape) cell runs; otherwise the documented skip reason."""
    cfg = get_config(arch)
    sh = SHAPES[shape]
    if cfg.is_encoder and sh.kind == "decode":
        return "encoder-only: no decode step"
    if shape == "long_500k" and cfg.block_pattern == ("attn",):
        return "pure full attention: long_500k needs sub-quadratic attention"
    if shape == "long_500k" and arch == "llama-3.2-vision-11b":
        return "full self-attention backbone: long_500k needs sub-quadratic attention"
    return None


def all_cells() -> list[tuple[str, str, Optional[str]]]:
    return [(a, s, cell_skip_reason(a, s)) for a in ARCHS for s in SHAPES]


# ------------------------------------------------------------------ smoke configs
def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: small widths, few experts, tiny vocab —
    the same overrides as the JAX package's ``smoke_config``, so both
    packages build the same smoke model."""
    cfg = get_config(name)
    common = dict(
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, 4 * cfg.num_kv_heads // cfg.num_heads),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        sliding_window=16,
        remat="none",
        dtype="float32",
        embed_scale=math.sqrt(64.0) if cfg.embed_scale != 1.0 else 1.0,
    )
    rem = len(cfg.remainder_layers)
    layers = 2 * cfg.period + rem
    overrides = dict(num_layers=layers, **common)
    if cfg.is_moe:
        overrides.update(num_experts=8, num_experts_per_tok=2)
    if cfg.family == "ssm":
        overrides.update(ssm_state_dim=16, ssm_head_dim=16, ssm_expand=2,
                         ssm_chunk=8)   # d_inner=128, 8 heads
    if cfg.family == "hybrid":
        overrides.update(lru_width=64, lru_heads=4)
    if cfg.family == "vlm":
        overrides.update(img_tokens=8)
    return cfg.replace(**overrides)


SMOKE_SHAPE = ShapeConfig("smoke", seq_len=32, global_batch=2, kind="train")
