"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060]

d_inner = 2*768 = 1536, 24 SSD heads of dim 64, state 128, conv width 4.
Attention-free: runs the long_500k cell with O(1) per-token state.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=24,                # == ssm heads (d_inner / ssm_head_dim)
    n_kv_heads=24,
    d_ff=0,                    # no MLP — Mamba2 blocks only
    vocab_size=50_280,
    head_dim=64,
    rope=False,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
    conv_width=4,
    tie_embeddings=True,
    block_pattern=("mamba2",),
    source="arXiv:2405.21060; unverified",
))
