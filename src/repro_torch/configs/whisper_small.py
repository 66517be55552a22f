"""whisper-small [audio] — enc-dec, conv frontend (stub).  [arXiv:2212.04356]

Backbone only: the mel/conv frontend is a stub — ``input_specs`` provides
precomputed frame embeddings (B, 1500, d_model).  Decoder self-attention is
causal with a KV cache; cross-attention reads the encoder output.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,               # decoder layers
    encoder_layers=12,
    encoder_seq=1500,          # 30 s of audio at 50 Hz after the conv stub
    d_model=768,
    n_heads=12,
    n_kv_heads=12,             # MHA (GQA kv=12)
    d_ff=3072,
    vocab_size=51_865,
    act="gelu",
    rope=False,                # Whisper uses absolute positions
    tie_embeddings=True,       # decoder output head shares the token embedding
    norm="layernorm",
    block_pattern=("xattn",),
    frontend="audio_stub",
    source="arXiv:2212.04356; unverified",
))
