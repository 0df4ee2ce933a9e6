# Copy of repro/configs/llama32_vision_11b.py.
"""llama-3.2-vision-11b [hf:meta-llama/Llama-3.2-11B-Vision]: 40L d_model=4096
32H (GQA kv=8) d_ff=14336 vocab=128256. Cross-attention image layers every 5th
layer (8 of 40). Vision frontend is a STUB: ``input_specs`` provides precomputed
patch embeddings (B, img_tokens, d_model)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    # period of 5: positions 0-3 self-attention, position 4 cross-attention
    block_pattern=("attn", "attn", "attn", "attn", "cross"),
    rope_theta=500_000.0,
    mlp_kind="swiglu",
    img_tokens=1601,                # 1 tile × (40×40 patches + 1 cls)
)
