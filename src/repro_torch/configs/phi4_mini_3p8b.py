"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA.  [arXiv:2412.08905; hf]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=200_064,
    act="swiglu",
    rope=True,
    tie_embeddings=True,
    source="arXiv:2412.08905; hf",
))
