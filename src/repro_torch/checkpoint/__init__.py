"""repro_torch.checkpoint — async atomic checkpoints (port of
``repro.checkpoint``)."""
from .checkpointer import Checkpointer, config_hash

__all__ = ["Checkpointer", "config_hash"]
