# Copy of repro/configs/starcoder2_3b.py.
"""starcoder2-3b [arXiv:2402.19173]: 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152. Sliding-window attention (4096), RoPE, LayerNorm + plain-GeLU MLP.
Sliding window ⇒ sub-quadratic ⇒ long_500k runs (ring KV cache)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    block_pattern=("sliding",),
    sliding_window=4096,
    rope_theta=100_000.0,
    mlp_kind="gelu",
    norm="layernorm",
)
