"""Model / shape configuration system.

One ``ModelConfig`` per assigned architecture (exact public specs) plus the
paper-native models.  Shapes are the four assigned input-shape cells; the
``kind`` decides which step gets lowered (train / prefill / decode).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

# ---------------------------------------------------------------------------
# Shapes (assigned; LM shapes are seq_len x global_batch)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads

    # attention features
    rope: bool = True
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    local_window: int = 0           # sliding-window size for "local" blocks
    causal: bool = True

    # mlp
    act: str = "swiglu"             # swiglu | geglu | gelu
    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # block layout: repeating pattern of block kinds + optional tail.
    # kinds: "attn" (global), "local" (windowed attn), "rec" (RG-LRU),
    #        "mamba2" (SSD), "xattn" (decoder block w/ cross-attention)
    block_pattern: tuple = ("attn",)
    tail_pattern: tuple = ()

    # ssm / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    conv_width: int = 4
    lru_width: int = 0

    # encoder-decoder (audio)
    encoder_layers: int = 0
    encoder_seq: int = 0            # e.g. Whisper's 1500 frames
    frontend: str = "none"          # "none" | "audio_stub" | "vq_stub"

    # numerics / embedding
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    norm: str = "rmsnorm"           # rmsnorm | layernorm

    # citation provenance
    source: str = ""

    # ----- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up so it shards evenly over 16-way TP and 128 lanes."""
        return _round_up(self.vocab_size, 256)

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def subquadratic(self) -> bool:
        """True when serve-time cost per token is o(seq): no global-attn blocks."""
        kinds = set(self.block_pattern) | set(self.tail_pattern)
        return "attn" not in kinds and "xattn" not in kinds

    @property
    def n_pattern_groups(self) -> int:
        if not self.block_pattern:
            return 0
        body = self.n_layers - len(self.tail_pattern)
        assert body % len(self.block_pattern) == 0, (
            f"{self.name}: {self.n_layers} layers do not factor into "
            f"pattern {self.block_pattern} + tail {self.tail_pattern}")
        return body // len(self.block_pattern)

    @property
    def d_inner(self) -> int:         # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def supports_shape(self, shape: ShapeConfig) -> bool:
        """Assigned-cell applicability (skips documented in DESIGN.md §4):
        long_500k needs sub-quadratic serving — global/cross attention
        (incl. the whisper decoder's full self-attention) disqualifies."""
        if shape.name == "long_500k":
            return self.subquadratic
        return True

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # A reduced config of the same family for CPU smoke tests.
    def smoke(self) -> "ModelConfig":
        n_pat = len(self.block_pattern) or 1
        layers = n_pat * 2 + len(self.tail_pattern)
        heads = min(self.n_heads, 4)
        kv = max(1, min(self.n_kv_heads, heads))
        while heads % kv:
            kv -= 1
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=layers,
            d_model=64,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=16,
            d_ff=96 if self.n_experts == 0 else 32,
            vocab_size=512,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            local_window=min(self.local_window, 8) if self.local_window else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else self.ssm_head_dim,
            lru_width=64 if self.lru_width else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=16 if self.encoder_seq else 0,
            dtype="float32",
        )


# Registry --------------------------------------------------------------------

_REGISTRY: dict[str, "ModelConfig"] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate config {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from . import _load_all  # late import to avoid cycles
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    from . import _load_all
    _load_all()
    return sorted(_REGISTRY)
