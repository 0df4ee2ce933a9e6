# Copy of repro/configs/phi35_moe_42b_a6_6b.py.
"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct]: 32L d_model=4096
32H (GQA kv=8), MoE 16 experts top-2, expert d_ff=6400, vocab=32064."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,                      # MoE expert intermediate size
    vocab_size=32064,
    block_pattern=("attn",),
    rope_theta=10000.0,
    mlp_kind="swiglu",
    num_experts=16,
    num_experts_per_tok=2,
    norm="layernorm",               # phi family uses LayerNorm
)
