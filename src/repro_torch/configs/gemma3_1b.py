# Copy of repro/configs/gemma3_1b.py.
"""gemma3-1b [hf:google/gemma-3-1b-pt]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144. 5 local (sliding-512) : 1 global layer pattern, 128k-class context,
head_dim=256, qk-norm, GeGLU, logit softcap, embeddings scaled by sqrt(d).

long_500k: runs — local layers use O(window) ring caches; the 1-in-6 global
layers are linear-per-token at decode (see DESIGN.md §Arch-applicability)."""
import math

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    block_pattern=("sliding", "sliding", "sliding", "sliding", "sliding", "attn"),
    sliding_window=512,
    rope_theta=1_000_000.0,
    qk_norm=True,
    mlp_kind="geglu",
    tie_embeddings=True,
    logit_softcap=30.0,
    embed_scale=math.sqrt(1152.0),
)
