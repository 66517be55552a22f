"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1 attn : 2 rec.
[arXiv:2402.19427]

38 layers = 12 x (rec, rec, local-attn) + 2 trailing rec blocks.  Local
window 2048 + O(1) recurrent state makes the long_500k cell runnable.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,              # MQA
    d_ff=12_288,
    vocab_size=256_000,
    head_dim=256,
    act="geglu",
    rope=True,
    local_window=2048,
    lru_width=4096,
    conv_width=4,
    block_pattern=("rec", "rec", "local"),
    tail_pattern=("rec", "rec"),
    source="arXiv:2402.19427; unverified",
))
