"""Shared layer primitives (port of ``repro.models.layers``).

The reference keeps f32 master parameters and casts each to the compute
dtype at every use; the port casts them once at load
(``Transformer.load``), which gives the same numbers.  Norm scales and
LayerNorm biases stay f32: the reference reads them in f32 (``1 + scale``,
``y * scale + bias``), never in the compute dtype.  The MLP's biases are in
the compute dtype, as the reference casts them.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..runtime import mesh_ctx


def upcast(x):
    """``x`` in f32, the reference's accumulation dtype; f64 stays f64 (the
    float64 yardstick runs)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def rms_norm(x, scale, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)``, computed in f32."""
    dt = x.dtype
    xf = upcast(x)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + upcast(scale))).to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """``(x - mean) * rsqrt(var + eps) * scale + bias``, computed in f32
    (no ``1 +``: a LayerNorm scale is initialised to ones)."""
    xf = upcast(x)
    return F.layer_norm(xf, xf.shape[-1:], scale.to(xf.dtype), bias.to(xf.dtype),
                        eps).to(x.dtype)


def apply_norm(x, p, kind: str):
    """The norm ``kind`` (``rmsnorm`` | ``layernorm``) with the leaves of ``p``."""
    if kind == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def rope_angles(positions, head_dim: int, theta: float):
    """positions: int tensor (...,); returns (cos, sin) of shape (..., hd/2)."""
    half = head_dim // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def sinusoid_freqs(d: int) -> torch.Tensor:
    """``sinusoid``'s (d // 2,) frequencies, a host tensor: made in float64
    numpy and cast to f32 before the product, as the reference's f32
    positions times its numpy table are: at positions up to 1499 another
    order of rounding moves sin and cos by ~1e-4."""
    half = d // 2
    return torch.from_numpy(
        np.exp(-math.log(10_000.0) * np.arange(half) / half).astype(np.float32))


def sinusoid(positions, d: int, dtype, freqs=None):
    """Whisper's encoder position table: ``cat(sin(ang), cos(ang))`` over
    ``ang = positions * freqs`` in f32, (..., d) in ``dtype``.  ``freqs``
    is ``sinusoid_freqs(d)`` on the positions' device, copied there when
    not given: a model passes its own, made once, so that no host array is
    copied in while a CUDA graph is captured."""
    if freqs is None:
        freqs = sinusoid_freqs(d).to(positions.device)
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def apply_rope(x, cos, sin):
    """Split-half RoPE.  x: (B, S, ..., head_dim); cos/sin: (B|1, S, hd/2),
    cast to x's dtype before the multiply (as the reference does)."""
    x1, x2 = x.chunk(2, dim=-1)
    shape = tuple(cos.shape[:2]) + (1,) * (x.dim() - 3) + tuple(cos.shape[-1:])
    cos = cos.reshape(shape).to(x.dtype)
    sin = sin.reshape(shape).to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def gelu_tanh(x):
    """The reference's ``jax.nn.gelu(approximate=True)``, the tanh form
    (PyTorch's default ``F.gelu`` is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


GATED_ACTS = {"swiglu": F.silu, "geglu": gelu_tanh}
UNGATED_ACTS = {"gelu": gelu_tanh}      # the ungated act the port's configs use


def mlp(x, p, act: str = "swiglu"):
    """Dense FFN.  Gated (``swiglu``: silu, ``geglu``: tanh gelu):
    ``(act(x @ w_gate) * (x @ w_up)) @ w_down``.  Otherwise ungated,
    ``act(x @ w_up + b_up) @ w_down + b_down``, each bias only where ``p``
    holds it (``gelu`` is the tanh form)."""
    if act in GATED_ACTS:
        h = GATED_ACTS[act](x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = x @ p["w_up"]
        if "b_up" in p:
            h = h + p["b_up"]
        h = UNGATED_ACTS[act](h)
    h = mesh_ctx.shard(h, "batch", "seq", "mlp")
    out = h @ p["w_down"]
    if "b_down" in p:
        out = out + p["b_down"]
    return out


def embed_lookup(table, tokens):
    return F.embedding(tokens, table)


def causal_conv1d(x, w, b=None):
    """x: (B, S, C), w: (K, C) depthwise causal; returns (B, S, C).

    A sum over K shifted copies of the left-padded input, in x's dtype, as
    the reference computes it."""
    k = w.shape[0]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + s, :] * w[i].to(x.dtype)
    if b is not None:
        out = out + b.to(x.dtype)
    return out


def conv1d_update(state, x_t, w, b=None):
    """Single-token conv update.  state: (B, K-1, C); x_t: (B, C).  Returns
    (new state, y); the window is summed in f32, as the reference does."""
    window = torch.cat([state, x_t[:, None, :]], dim=1)          # (B, K, C)
    y = torch.einsum("bkc,kc->bc", window.float(), w.float()).to(x_t.dtype)
    if b is not None:
        y = y + b.to(x_t.dtype)
    return window[:, 1:, :], y
