"""Device selection for the port's entry points.

Entry points run on the card: with ``device=None`` they take ``cuda`` and
raise when no card is visible.  The CPU is used only when the caller names it
(the tests do), never as a silent fallback.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda``; raise ``RuntimeError`` if CUDA is asked for but
    no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on an NVIDIA GPU and torch.cuda.is_available() "
            "is False; pass device='cpu' explicitly to run the plain PyTorch "
            "versions on the CPU")
    return dev
