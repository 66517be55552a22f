"""Int8 gradient compression with error feedback (port of
``repro.optim.grad_compress``).

Each gradient leaf plus its error residual is quantized to int8 with one f32
scale per tensor and dequantized again; what the rounding lost is carried to
the next step, so repeated rounding does not bias training.  On one card
nothing crosses a wire, so this is the numerics of the compressed reduce.
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten


def init_error(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def compress_decompress(grads, error):
    """Returns (dequantized grads, new error residuals)."""
    def one(g, e):
        gf = g.float() + e
        scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        deq = q.float() * scale
        return deq, gf - deq

    flat_g, spec = tree_flatten(grads)
    outs = [one(g, e) for g, e in zip(flat_g, tree_leaves(error))]
    return (tree_unflatten([o[0] for o in outs], spec),
            tree_unflatten([o[1] for o in outs], spec))


def compression_ratio(params) -> float:
    """Bytes saved on the wire: f32 -> int8 + one f32 scale per tensor."""
    total = sum(x.numel() * 4 for x in tree_leaves(params))
    wire = sum(x.numel() * 1 + 4 for x in tree_leaves(params))
    return total / wire
