"""AdamW with cosine schedule and global-norm clipping (port of
``repro.optim.adamw``; no ``torch.optim``).

The reference's formula in f32: clip by the global norm, then
bias-corrected moments, then decoupled weight decay.  Moments mirror the
parameter tree.  ``update`` writes the new parameters and moments into the
given tensors (under ``torch.no_grad``), where the reference returns new
arrays and donates the old ones.

Leaves may be DTensors (sharded training): each leaf updates shard by
shard, the global norm sums each leaf's partial sum of squares over the
ranks (one scalar each, no leaf is gathered), and the schedule's scalars
stay plain 0-d tensors, taken as replicated beside the leaves.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch
from torch.utils._pytree import tree_leaves, tree_map

from ..runtime.mesh_ctx import is_dtensor, replicating, whole


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Learning rate at ``step`` (an int or an integer tensor), f32: linear
    warmup, then a cosine decay to ``min_lr_ratio`` of the peak."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp((step + 1.0) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init(params) -> dict:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    leaf = tree_leaves(params)[0]
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(whole(torch.sum(torch.square(x.float())))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def update(grads, state, params, cfg: AdamWConfig):
    """Returns (params, state, metrics), the first two updated in place."""
    count = state["count"] + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
             if cfg.clip_norm else torch.ones((), device=gnorm.device))
    lr = schedule(cfg, whole(state["count"]))
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(b1, whole(count).float())
    bc2 = 1.0 - torch.pow(b2, whole(count).float())
    leaves = tree_leaves(params)
    with _replicating(leaves):
        for p, g, m, v in zip(leaves, tree_leaves(grads),
                              tree_leaves(state["m"]), tree_leaves(state["v"])):
            g = g.float() * scale
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * torch.square(g))
            step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr * step).to(p.dtype))
    state["count"] = count
    return params, state, {"grad_norm": gnorm, "lr": lr}


def _replicating(leaves):
    """Where the leaves are DTensors, plain tensors beside them (the 0-d
    scalars) count as replicated; else nothing."""
    if leaves and is_dtensor(leaves[0]):
        return replicating()
    return contextlib.nullcontext()
