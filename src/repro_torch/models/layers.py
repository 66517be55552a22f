"""Shared layer primitives (port of ``repro.models.layers``).

The reference keeps f32 master parameters and casts each to the compute
dtype at every use; the port casts them once at load
(``Transformer.load``), which gives the same numbers.  Norm scales stay f32:
the reference reads them in f32 (``1 + scale``), never in the compute dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x, scale, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)``, computed in f32."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def rope_angles(positions, head_dim: int, theta: float):
    """positions: int tensor (...,); returns (cos, sin) of shape (..., hd/2)."""
    half = head_dim // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """Split-half RoPE.  x: (B, S, ..., head_dim); cos/sin: (B|1, S, hd/2),
    cast to x's dtype before the multiply (as the reference does)."""
    x1, x2 = x.chunk(2, dim=-1)
    shape = tuple(cos.shape[:2]) + (1,) * (x.dim() - 3) + tuple(cos.shape[-1:])
    cos = cos.reshape(shape).to(x.dtype)
    sin = sin.reshape(shape).to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def mlp(x, p):
    """SwiGLU FFN: ``(silu(x @ w_gate) * (x @ w_up)) @ w_down``."""
    g = F.silu(x @ p["w_gate"])
    h = g * (x @ p["w_up"])
    return h @ p["w_down"]


def embed_lookup(table, tokens):
    return F.embedding(tokens, table)
