"""chameleon-34b [vlm] — early-fusion, VQ image tokens.  [arXiv:2405.09818]

Early fusion means image patches arrive as VQ token ids drawn from the same
unified 65k vocabulary as text — the backbone is an ordinary decoder-only
transformer; the VQ tokenizer frontend is a stub (``input_specs`` supplies
token ids directly), per the assignment.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22_016,
    vocab_size=65_536,
    act="swiglu",
    rope=True,
    frontend="vq_stub",
    source="arXiv:2405.09818; unverified",
))
