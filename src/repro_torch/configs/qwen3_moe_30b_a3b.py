# Copy of repro/configs/qwen3_moe_30b_a3b.py.
"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B]: 48L d_model=2048 32H (GQA kv=4)
MoE 128 experts top-8, expert d_ff=768, vocab=151936. qk-norm, head_dim=128
(Qwen3 decouples head_dim from d_model/num_heads)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,                       # MoE expert intermediate size
    vocab_size=151936,
    block_pattern=("attn",),
    rope_theta=1_000_000.0,
    qk_norm=True,
    mlp_kind="swiglu",
    num_experts=128,
    num_experts_per_tok=8,
)
