"""repro_torch.optim — AdamW and int8 gradient compression (port of
``repro.optim``), and the paper nets' plain SGD."""
from . import adamw, grad_compress, sgd

__all__ = ["adamw", "grad_compress", "sgd"]
