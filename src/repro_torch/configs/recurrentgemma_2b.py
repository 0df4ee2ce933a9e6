# Copy of repro/configs/recurrentgemma_2b.py.
"""recurrentgemma-2b [arXiv:2402.19427 Griffin]: 26L d_model=2560 10H (GQA kv=1)
d_ff=7680 vocab=256000. Pattern 2×RG-LRU : 1×local-attention (window 2048),
lru_width=2560. Hybrid ⇒ long_500k runs (O(1) recurrent state + ring KV)."""
import math

from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "sliding"),
    sliding_window=2048,
    rope_theta=10000.0,
    mlp_kind="geglu",
    lru_width=2560,
    lru_heads=10,                    # block-diagonal gates, 256-wide blocks
    tie_embeddings=True,
    embed_scale=math.sqrt(2560.0),
)
