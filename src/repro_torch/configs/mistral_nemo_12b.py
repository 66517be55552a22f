"""mistral-nemo-12b [dense] — GQA, 128k ctx.  [hf:mistralai/Mistral-Nemo-Base-2407]

Full (global) attention: the long_500k cell is skipped per DESIGN.md §4.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=131_072,
    head_dim=128,
    act="swiglu",
    rope=True,
    rope_theta=1_000_000.0,
    source="hf:mistralai/Mistral-Nemo-Base-2407; hf",
))
