# Copy of repro/configs/chatglm3_6b.py.
"""chatglm3-6b [arXiv:2406.12793]: 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024. 2d (partial, interleaved-pair) RoPE on half the head dim."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    block_pattern=("attn",),
    rope_style="partial2d",
    rope_fraction=0.5,
    rope_theta=10000.0,
    mlp_kind="swiglu",
)
