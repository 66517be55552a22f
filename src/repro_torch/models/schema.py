"""Param schema: one declaration drives parameter init (port of
``repro.models.schema``, without the sharding axes the port does not use).

A ``Schema`` is a nested dict (or list, for per-layer blocks) whose leaves
are ``P`` descriptors: shape plus init rule.  Init draws from an explicit
``torch.Generator`` with the reference's scale rules: ``normal`` leaves are
``scale * N(0, 1)`` with ``scale`` defaulting to ``1/sqrt(fan_in)``, where
fan-in is the last-but-one dimension.  The two frameworks draw different
numbers from the same seed, so tests that compare against the reference
convert its parameters (``models.bridge``) instead.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Union

import torch


@dataclass(frozen=True)
class P:
    shape: tuple
    init: str = "normal"              # normal | zeros | ones
    scale: Optional[float] = None     # stddev; None -> 1/sqrt(fan_in)


Schema = Union[dict, list]            # nested str/int -> P | Schema


def _fan_in(p: P) -> int:
    # Last-but-one dim is the canonical fan-in for 2D+; fall back to last.
    if len(p.shape) >= 2:
        return int(p.shape[-2])
    return int(p.shape[-1]) if p.shape else 1


def _children(s: Schema):
    return s.items() if isinstance(s, dict) else enumerate(s)


def init_params(schema: Schema, generator: torch.Generator,
                dtype: torch.dtype = torch.float32):
    """Real parameters on ``generator.device``, leaves drawn in schema order."""
    dev = generator.device

    def make(p: P):
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dtype, device=dev)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dtype, device=dev)
        scale = p.scale if p.scale is not None else 1.0 / math.sqrt(max(1, _fan_in(p)))
        return (scale * torch.randn(p.shape, generator=generator,
                                    device=dev)).to(dtype)

    def rec(s: Schema):
        out = {k: (make(v) if isinstance(v, P) else rec(v))
               for k, v in _children(s)}
        return out if isinstance(s, dict) else [out[i] for i in range(len(s))]

    return rec(schema)
