"""repro_torch.optim — AdamW and int8 gradient compression (port of
``repro.optim``)."""
from . import adamw, grad_compress

__all__ = ["adamw", "grad_compress"]
