# Copy of repro/configs/mamba2_2_7b.py.
"""mamba2-2.7b [arXiv:2405.21060]: 64L d_model=2560 attention-free, SSD
(state-space duality), ssm_state=128, expand=2 (d_inner 5120), head_dim 64
(80 heads), conv width 4. long_500k runs (O(1) state decode)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=1,                    # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,                         # no MLP: the SSD mixer is the block
    vocab_size=50280,
    block_pattern=("ssd",),
    rope_style="none",
    ssm_state_dim=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_ngroups=1,
    ssm_conv_width=4,
    ssm_chunk=128,
    tie_embeddings=True,
)
