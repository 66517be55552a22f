"""Model substrate: the decoders over block patterns, the paper's own nets
(``cnn``, ``seq2seq``) and the reference-parameter bridge."""
from .bridge import cnn_params_from_jax, params_from_jax, seq2seq_params_from_jax
from .transformer import RunOpts, Transformer

__all__ = ["RunOpts", "Transformer", "cnn_params_from_jax", "params_from_jax",
           "seq2seq_params_from_jax"]
