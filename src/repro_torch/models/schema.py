"""Param schema: one declaration drives parameter init and sharding (port of
``repro.models.schema``).

A ``Schema`` is a nested dict (or list, for per-layer blocks) whose leaves
are ``P`` descriptors: shape, logical axis names (one per dim, the
reference's: ``runtime.sharding_rules`` maps them to mesh axes) and init
rule.  Init draws from an explicit
``torch.Generator`` with the reference's scale rules: ``normal`` leaves are
``scale * N(0, 1)`` with ``scale`` defaulting to ``1/sqrt(fan_in)``, where
fan-in is the last-but-one dimension.  The two frameworks draw different
numbers from the same seed, so tests that compare against the reference
convert its parameters (``models.bridge``) instead.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Union

import torch


@dataclass(frozen=True)
class P:
    shape: tuple
    axes: tuple                       # logical axis names (str | None) per dim
    init: str = "normal"              # normal | zeros | ones
    scale: Optional[float] = None     # stddev; None -> 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"P: shape {self.shape} vs axes {self.axes}")


Schema = Union[dict, list]            # nested str/int -> P | Schema


def _fan_in(p: P) -> int:
    # Last-but-one dim is the canonical fan-in for 2D+; fall back to last.
    if len(p.shape) >= 2:
        return int(p.shape[-2])
    return int(p.shape[-1]) if p.shape else 1


def _children(s: Schema):
    return s.items() if isinstance(s, dict) else enumerate(s)


def map_schema(schema: Schema, fn: Callable[[tuple, P], object]):
    """The schema's tree with ``fn(path, leaf)`` at each leaf (lists stay
    lists)."""
    def rec(s: Schema, prefix=()):
        out = {k: (fn(prefix + (k,), v) if isinstance(v, P) else rec(v, prefix + (k,)))
               for k, v in _children(s)}
        return out if isinstance(s, dict) else [out[i] for i in range(len(s))]
    return rec(schema)


def logical_axes(schema: Schema):
    """Tree of logical-axis tuples mirroring the parameter tree."""
    return map_schema(schema, lambda _, p: tuple(p.axes))


def init_params(schema: Schema, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                leaf: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None):
    """Real parameters on ``generator.device``, leaves drawn in schema order.

    ``leaf(key, tensor)``, when given, maps each leaf right after it is
    drawn (a cast, a move), so only one leaf at ``dtype`` exists at a time;
    the draws, and so the numbers, are the same as without it."""
    dev = generator.device

    def make(p: P):
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dtype, device=dev)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dtype, device=dev)
        scale = p.scale if p.scale is not None else 1.0 / math.sqrt(max(1, _fan_in(p)))
        return torch.randn(p.shape, generator=generator,
                           device=dev).mul_(scale).to(dtype)

    def rec(s: Schema):
        out = {}
        for k, v in _children(s):
            if isinstance(v, P):
                out[k] = make(v) if leaf is None else leaf(str(k), make(v))
            else:
                out[k] = rec(v)
        return out if isinstance(s, dict) else [out[i] for i in range(len(s))]

    return rec(schema)


def abstract_params(schema: Schema, device, dtype: torch.dtype = torch.float32):
    """Uninitialised parameters of the schema's shapes: made under a
    ``FakeTensorMode`` they are fake tensors that hold no memory."""
    return map_schema(schema, lambda _, p: torch.empty(p.shape, dtype=dtype,
                                                        device=device))
