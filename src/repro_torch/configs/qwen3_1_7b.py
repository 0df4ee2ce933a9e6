# Copy of repro/configs/qwen3_1_7b.py.
"""qwen3-1.7b [hf:Qwen/Qwen3-1.7B family]: 28L d_model=2048 16H (GQA kv=8)
d_ff=6144 vocab=151936, qk-norm, head_dim=128, tied embeddings."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    block_pattern=("attn",),
    rope_theta=1_000_000.0,
    qk_norm=True,
    mlp_kind="swiglu",
    tie_embeddings=True,
)
