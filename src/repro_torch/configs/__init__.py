"""Config registry: one module per assigned architecture + paper-native models.

Use ``get_config(name)`` / ``list_configs()``; CLI flag ``--arch <id>``.
"""
from .base import SHAPES, ModelConfig, ShapeConfig, get_config, list_configs

# The 10 assigned architectures (the arch x shape dry-run matrix).
ARCHS = [
    "phi4-mini-3.8b",
    "qwen2-0.5b",
    "mistral-nemo-12b",
    "starcoder2-15b",
    "chameleon-34b",
    "granite-moe-1b-a400m",
    "qwen3-moe-30b-a3b",
    "whisper-small",
    "recurrentgemma-9b",
    "mamba2-130m",
]

# Paper-native model families (Fig. 2/3/4 reproductions; not dry-run cells).
PAPER_ARCHS = ["paper-alexnet", "paper-resnet50", "paper-seq2seq"]

_LOADED = False


def _load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from . import (  # noqa: F401
        chameleon_34b,
        granite_moe_1b_a400m,
        mamba2_130m,
        mistral_nemo_12b,
        paper_native,
        phi4_mini_3p8b,
        qwen2_0p5b,
        qwen3_moe_30b_a3b,
        recurrentgemma_9b,
        starcoder2_15b,
        whisper_small,
    )


__all__ = ["ARCHS", "PAPER_ARCHS", "SHAPES", "ModelConfig", "ShapeConfig",
           "get_config", "list_configs"]
