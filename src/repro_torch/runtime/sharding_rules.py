"""Logical axis -> mesh axis resolution for parameters, batches and caches
(port of ``repro.runtime.sharding_rules``).

Layout: FSDP shards the d_model ("embed") dim of every weight over
``data``; TP shards heads / mlp / vocab / experts / lru over ``model``;
``pod`` is pure DP (parameters replicated across pods, the batch sharded
over pod x data).  Every rule is divisibility-guarded: a dim that does not
divide evenly stays unsharded, as in the reference.

The functions return ``mesh_ctx.PartitionSpec`` trees mirroring the tree
they read; ``distribute_tree`` places a tree of tensors by them as
DTensors.  They read only the mesh's axis names and sizes.
"""
from __future__ import annotations

from typing import Optional

from . import mesh_ctx
from .mesh_ctx import PartitionSpec

PARAM_RULES: dict[str, tuple] = {
    "embed": ("data",),          # FSDP
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "mlp": ("model",),
    "experts": ("model",),
    "expert_mlp": (),
    "lru": ("model",),
    "layers": (),
}

# Activation rules live in mesh_ctx.ACTIVATION_RULES; cache rules here.
CACHE_RULES: dict[str, tuple] = {
    "batch": ("data",),
    "cache": (),                 # the cache length axis (shard_cache_len: -> model)
    "kv_heads": ("model",),
    "head_dim": (),
    "frames": (),
    "lru": ("model",),
    "inner": (),
    "state": (),
    "conv": (),
    "layers": (),
    "ssm_heads": (),
}


def spec_from_axes(axes: tuple, dims: tuple, mesh, rules: dict) -> PartitionSpec:
    """The spec of a tensor of shape ``dims`` whose dims name the logical
    ``axes`` (``mesh_ctx.spec_for`` under ``rules``)."""
    return mesh_ctx.spec_for(*axes, rules=rules, mesh=mesh, dims=dims)


def param_specs(schema, mesh):
    """Tree of PartitionSpecs for the parameters (and the AdamW moments) of
    a ``models.schema`` schema."""
    from ..models.schema import map_schema     # the models import serve_lib
    return map_schema(schema, lambda _, p: spec_from_axes(
        tuple(p.axes), tuple(p.shape), mesh, PARAM_RULES))


def _shape(x) -> tuple:
    """A shape, a ``(shape, dtype)`` pair or anything with ``.shape``."""
    if hasattr(x, "shape"):
        return tuple(x.shape)
    if len(x) == 2 and isinstance(x[0], (tuple, list)):
        return tuple(x[0])
    return tuple(x)


def batch_specs(batch_shapes: dict, mesh) -> dict:
    """Specs for a training or prefill batch dict (values: shapes, ``(shape,
    dtype)`` pairs or tensors)."""
    out = {}
    for k, v in batch_shapes.items():
        shape = _shape(v)
        if k == "frames":
            axes = ("batch", "frames", "embed")
        elif k in ("tokens", "mask"):
            axes = ("batch", "seq")
        else:
            axes = ("batch",) + (None,) * (len(shape) - 1)
        out[k] = spec_from_axes(axes, shape, mesh, mesh_ctx.ACTIVATION_RULES)
    return out


_CACHE_BODY = {
    "k": ("batch", "cache", "kv_heads", "head_dim"),
    "v": ("batch", "cache", "kv_heads", "head_dim"),
    "xk": ("batch", "cache", "kv_heads", "head_dim"),
    "xv": ("batch", "cache", "kv_heads", "head_dim"),
    "conv": ("batch", "conv", "inner"),
    "h": ("batch", "lru"),
    "ssm": ("batch", "ssm_heads", "head_dim", "state"),
    # the paged pool (P, pt, KV, hd): pages and page offsets are no batch
    "k_pages": (None, None, "kv_heads", "head_dim"),
    "v_pages": (None, None, "kv_heads", "head_dim"),
}


def cache_leaf_axes(name: str, shape: tuple) -> tuple:
    """Logical axes of one leaf of the port's flat cache dict: the
    reference's ``_cache_leaf_axes`` per leaf name, behind the leading
    stacked-layers dim every leaf but ``pos`` and ``block_tables`` has.
    The paged pool's K/V, which the reference leaves whole, split their kv
    heads as the contiguous cache's do."""
    if name == "pos":
        return ("batch",)
    if name == "block_tables":
        return (None, None)
    axes = ("layers",) + _CACHE_BODY[name]
    if len(axes) != len(shape):
        raise ValueError(f"cache leaf {name!r} of shape {shape}: axes {axes}")
    return axes


def cache_specs(cache_shapes: dict, mesh, rules: Optional[dict] = None) -> dict:
    """Specs for a decode cache dict (``Transformer.cache_spec`` or
    ``paged_cache_spec``, or the tensors themselves)."""
    rules = dict(CACHE_RULES, **(rules or {}))
    out = {}
    for name, v in cache_shapes.items():
        shape = _shape(v)
        out[name] = spec_from_axes(cache_leaf_axes(name, shape), shape, mesh, rules)
    return out


def replicated(mesh) -> PartitionSpec:
    """The spec of a replicated value (any rank: no entry names an axis)."""
    del mesh
    return PartitionSpec()


def distribute_tree(tree, specs, mesh):
    """Each tensor of ``tree`` as a DTensor on ``mesh`` with the spec at the
    same place in ``specs`` (a spec stands for a whole subtree); a plain
    tensor is taken as the full value, the same on every rank."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs if isinstance(specs, PartitionSpec)
                                   else specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute_tree(v, specs if isinstance(specs, PartitionSpec)
                                          else specs[i], mesh)
                          for i, v in enumerate(tree))
    return mesh_ctx.distribute(tree, mesh, specs)
