"""qwen3-moe-30b-a3b [moe] — 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,                  # per-expert hidden (moe_intermediate_size)
    vocab_size=151_936,
    head_dim=128,
    n_experts=128,
    top_k=8,
    act="swiglu",
    rope=True,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
))
