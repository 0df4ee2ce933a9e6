# Copy of repro/configs/hubert_xlarge.py.
"""hubert-xlarge [arXiv:2106.07447]: 48L d_model=1280 16H (MHA, kv=16) d_ff=5120
vocab=504 (masked-unit prediction codebook). Encoder-only (bidirectional, no
decode step — decode_32k/long_500k cells are skipped). The audio frontend (conv
feature extractor + conv positional embedding) is a STUB: ``input_specs``
provides precomputed frame embeddings (B, frames, d_model)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    block_pattern=("attn",),
    causal=False,                   # encoder-only, bidirectional
    rope_style="none",              # conv positional embedding is part of the stub
    mlp_kind="gelu",
    norm="layernorm",
)
