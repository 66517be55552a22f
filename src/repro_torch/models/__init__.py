"""Model substrate: the dense GQA decoder and the reference-parameter bridge."""
from .bridge import params_from_jax
from .transformer import RunOpts, Transformer

__all__ = ["RunOpts", "Transformer", "params_from_jax"]
