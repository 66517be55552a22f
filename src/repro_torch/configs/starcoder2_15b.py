"""starcoder2-15b [dense] — GQA, RoPE.  [arXiv:2402.19173; hf]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24_576,
    vocab_size=49_152,
    act="gelu",
    rope=True,
    qkv_bias=True,
    norm="layernorm",
    source="arXiv:2402.19173; hf",
))
