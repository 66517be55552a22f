"""Global (mesh, logical-rule) context for activation sharding (port of
``repro.runtime.mesh_ctx``).

Model code calls ``shard(x, "batch", "seq", "embed")`` with *logical* axis
names; the step builders install a mesh and a rule set (``use_mesh``), and
the helper maps the names to mesh axes.  Without an installed mesh it
returns ``x`` untouched, so the models run on one device with no plumbing.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names, ``("data", "model")`` or ``("pod", "data",
"model")``.  A ``PartitionSpec`` is the port's own: one entry per tensor dim,
None, a mesh axis name or a tuple of names, as the reference's.
``placements`` turns one into DTensor placements, and ``shard`` is the eager
counterpart of ``with_sharding_constraint``: it redistributes a DTensor to
the spec's placements.  The rule functions (``_resolve``, ``spec_for``) read
only a mesh's axis names and sizes, so they take any object with
``axis_names`` and ``shape`` (``launch.mesh.CardMesh``) as well.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

# Logical axis -> preferred mesh axes (a tuple value shards over every one of
# them present in the mesh, e.g. batch over (pod, data)).
ACTIVATION_RULES: dict[str, tuple] = {
    "batch": ("pod", "data"),
    "seq": (),                # unsharded by default; SP binds it to ("model",)
    "seq_cp": ("model",),     # context-parallel attention (RunOpts.cp_attention)
    "groups": ("data",),      # hierarchical MoE dispatch groups
    "embed": (),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "capacity": (),
    "inner": ("model",),      # mamba d_inner
    "ssm_p": (),              # SSD head_dim; RunOpts.ssd_shard_p -> ("model",)
    "lru": ("model",),
    "state": (),
    "window": (),
    "frames": (),
}

_CTX: dict = {"mesh": None, "rules": None, "replicating": False}


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or a
    tuple of names (the dim sharded over all of them, major first)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or a names-and-sizes mesh."""
    return dict(zip(axis_names(mesh), tuple(mesh.shape)))


def check_mesh(mesh, what: str) -> None:
    """Refuse anything but a ``DeviceMesh`` over the reference's axis names."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"{what}: mesh must be a torch.distributed DeviceMesh "
                        f"(launch.mesh.one_card_mesh, elastic.make_mesh_over), "
                        f"not {type(mesh).__name__}")
    names = axis_names(mesh)
    if names not in (("data", "model"), ("pod", "data", "model")):
        raise ValueError(f"{what}: mesh axes {names}; the rules name "
                         "('data', 'model') or ('pod', 'data', 'model')")


def current_mesh():
    return _CTX["mesh"]


def _resolve(rules: dict, logical: Optional[str], mesh, dim: Optional[int] = None):
    """Map a logical axis to mesh axes; drop axes the dim does not divide by
    (an uneven shard is refused, as GSPMD refuses it: e.g. 24 heads never
    shard over a 16-way model axis)."""
    if logical is None:
        return None
    axes = rules.get(logical, ())
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    present = []
    size = 1
    for a in axes:
        if a not in sizes:
            continue
        nxt = size * sizes[a]
        if dim is not None and dim % nxt != 0:
            continue
        present.append(a)
        size = nxt
    if not present:
        return None
    return tuple(present) if len(present) > 1 else present[0]


def spec_for(*logical_axes: Optional[str], rules: Optional[dict] = None,
             mesh=None, dims: Optional[Sequence[Optional[int]]] = None) -> PartitionSpec:
    mesh = mesh if mesh is not None else _CTX["mesh"]
    rules = rules or _CTX["rules"] or ACTIVATION_RULES
    if mesh is None:
        raise ValueError("spec_for: no mesh context installed")
    dims = dims or (None,) * len(logical_axes)
    parts = []
    used: set = set()
    for ax, d in zip(logical_axes, dims):
        r = _resolve(rules, ax, mesh, d)
        rt = (r,) if isinstance(r, str) else (r or ())
        rt = tuple(a for a in rt if a not in used)   # one mesh axis per spec
        used.update(rt)
        parts.append(rt if len(rt) > 1 else (rt[0] if rt else None))
    return PartitionSpec(*parts)


def placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim that entry ``d`` names, ``Replicate()`` on the rest.  A mesh dim of
    size 1 splits nothing, so it is ``Replicate()`` whatever the spec names
    (DTensor's view rules refuse some shards of size-1 mesh dims that are
    no split at all)."""
    out = []
    for name, size in axis_sizes(mesh).items():
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        if len(dims) > 1:
            raise ValueError(f"spec {spec} names mesh axis {name!r} twice")
        out.append(Shard(dims[0]) if dims and size > 1 else Replicate())
    return tuple(out)


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def whole(x):
    """A DTensor's full tensor (gathered, or a partial sum reduced, on every
    rank of its mesh); any other value as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def distribute(x: torch.Tensor, mesh, spec: Sequence):
    """``x`` as a DTensor with ``spec``'s placements on ``mesh``: a DTensor
    is redistributed; a plain tensor, the same on every rank (a constant, a
    full tensor), is taken as replicated and cut locally, with no
    communication.  Its gradient comes back in the placements it had
    (``pin``), as the transpose of a sharding constraint constrains the
    cotangent."""
    want = placements(spec, mesh)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if tuple(x.placements) == want:
        return pin(x)
    return x.redistribute(mesh, want)


def pin(x):
    """``x``; a DTensor that needs a gradient gets it back in the placements
    it has (a redistribution to them).  DTensor places a gradient as its
    cheapest product falls, and a view's backward may then be asked to
    unflatten an uneven split (a (d, heads * hd) weight's gradient split
    over 16 ranks where its 14 heads are whole): pinned, the backward view
    inverts the forward's."""
    if isinstance(x, DTensor) and x.requires_grad:
        return x.redistribute(x.device_mesh, x.placements)
    return x


def _with_specs(tree, specs):
    """``(leaf, spec)`` of each tensor of ``tree``, in order, with the spec
    at the same place in ``specs`` (a spec stands for a whole subtree, as
    in ``sharding_rules.distribute_tree``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _with_specs(v, specs if isinstance(specs, PartitionSpec) else specs[k])
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _with_specs(v, specs if isinstance(specs, PartitionSpec) else specs[i])
    else:
        yield tree, specs


def _refill(tree, leaves):
    """``tree`` with its tensors replaced, in order, from iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _refill(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_refill(v, leaves) for v in tree)
    return next(leaves)


def _to_local(out):
    if isinstance(out, DTensor):
        return out.to_local()
    if isinstance(out, dict):
        return {k: _to_local(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_to_local(v) for v in out)
    return out


def on_local_shards(step, trees: Sequence, specs: Sequence, mesh, mode):
    """``step(*trees)`` as a function of this rank's local shards, for
    ``make_fx`` over a mesh: returns ``(fn, shards)``.

    ``trees`` hold global fake tensors of ``mode`` (shapes, no memory),
    ``specs`` their PartitionSpecs.  ``shards`` are this rank's local
    shards of every leaf, made in ``mode``; ``fn(*shards)`` rebuilds each
    leaf as a DTensor (``DTensor.from_local`` with the global shape and
    stride: a shard may be uneven) inside the traced function, calls
    ``step`` and returns its outputs with every DTensor as its local
    tensor.  Traced so, the graph's placeholders are the local shards and
    every op hangs off them; a DTensor given to the traced function itself
    would enter its graph as a lifted constant."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    shards, metas = [], []
    for tree, spec in zip(trees, specs):
        for leaf, sp in _with_specs(tree, spec):
            pl = placements(sp, mesh)
            local, _ = compute_local_shape_and_global_offset(tuple(leaf.shape), mesh, pl)
            with mode:
                shards.append(torch.empty(local, dtype=leaf.dtype, device=leaf.device))
            metas.append((pl, leaf.shape, leaf.stride()))

    def fn(*local):
        it = iter(DTensor.from_local(x, mesh, pl, run_check=False, shape=shape, stride=stride)
                  for x, (pl, shape, stride) in zip(local, metas))
        return _to_local(step(*[_refill(tree, it) for tree in trees]))
    return fn, shards


def gather_fsdp(tree):
    """``tree`` with each DTensor leaf whole over the ``data`` mesh axis,
    which FSDP splits a weight's d_model over (``sharding_rules``): the
    gather at a weight's use that GSPMD makes for a weight split over the
    axis the batch is split over.  Left to its own costs, DTensor gathers
    the activations over ``data`` for some products instead, which at a
    training batch moves more bytes than the weights.  The gradient comes
    back reduce-scattered.  ``tree`` itself without a mesh."""
    mesh = _CTX["mesh"]
    if mesh is None or "data" not in axis_names(mesh):
        return tree
    j = axis_names(mesh).index("data")

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(one(v) for v in x)
        if not isinstance(x, DTensor) or not isinstance(x.placements[j], Shard):
            return x
        return x.redistribute(x.device_mesh, [Replicate() if i == j else p
                                              for i, p in enumerate(x.placements)])
    return one(tree)


def shard(x, *logical_axes: Optional[str]):
    """Constrain ``x``'s sharding; returns ``x`` without an installed mesh."""
    mesh = _CTX["mesh"]
    if mesh is None:
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(f"rank mismatch: {logical_axes} vs shape {tuple(x.shape)}")
    return distribute(x, mesh, spec_for(*logical_axes, mesh=mesh, dims=tuple(x.shape)))


def run_local(fn, args: Sequence, in_axes: Sequence, out: Sequence):
    """``fn(*args)``; under an installed mesh, on each rank's local shards
    (``local_map``).  ``in_axes[i]`` names the logical axes of tensor
    ``args[i]`` (None: pass it as it is, a non-tensor); each is sharded to
    them first.  ``out`` is one ``(axes, shape)`` pair per output tensor of
    ``fn``, in order (``fn`` returns a tensor when ``out`` has one pair,
    else a tuple): the outputs come back as DTensors with those placements.
    This is how a kernel, whose wrapper takes plain tensors only, runs on a
    sharded tensor, and how a region of irregular indexing runs on the
    rows and heads each rank holds.  An entry of ``in_axes`` or ``out`` may
    be a ``PartitionSpec`` in place of logical axes: mesh axes, as they
    are."""
    mesh = _CTX["mesh"]
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map
    ins, placed = [], []
    for a, ax in zip(args, in_axes):
        if ax is None:
            ins.append(None)
            placed.append(a)
            continue
        x = distribute(a, mesh, ax) if isinstance(ax, PartitionSpec) else shard(a, *ax)
        ins.append(tuple(x.placements))
        placed.append(x)
    # local_map reads a tuple as one entry per output: each output's
    # placements go in as a list
    outs = [list(placements(ax if isinstance(ax, PartitionSpec)
                            else spec_for(*ax, mesh=mesh, dims=tuple(shape)), mesh))
            for ax, shape in out]
    # an input whole on a mesh dim that splits the work (some input or
    # output is sharded there) gets one partial gradient from each rank
    split = [any(isinstance(p[j], Shard) for p in [*filter(None, ins), *outs])
             for j in range(mesh.ndim)]
    grads = tuple(None if p is None else
                  tuple(Partial() if split[j] and isinstance(p[j], Replicate) else p[j]
                        for j in range(mesh.ndim))
                  for p in ins)
    def local(*a):
        return fn(*[_ContiguousGrad.apply(t) if isinstance(t, torch.Tensor)
                    and t.requires_grad else t for t in a])
    return local_map(local, out_placements=outs[0] if len(outs) == 1 else tuple(outs),
                     in_placements=tuple(ins), in_grad_placements=grads,
                     device_mesh=mesh)(*placed)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient: a
    ``local_map`` input's gradient goes on into DTensor's view ops, which
    run ``view`` on each rank's shard and refuse the strides a local
    function's backward can leave (a permuted einsum's)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def local_offset(x, dim: int) -> int:
    """Global index of the first element of this rank's shard of DTensor
    ``x`` along ``dim`` (even shards, as the divisibility guard makes
    them); 0 for a dim no mesh axis splits."""
    mesh = x.device_mesh
    off, size = 0, x.shape[dim]
    for j, pl in enumerate(x.placements):      # mesh dims in order: major first
        if isinstance(pl, Shard) and pl.dim == dim:
            size //= mesh.size(j)
            off += mesh.get_local_rank(j) * size
    return off


def write_local(dst, srcs: Sequence, fn) -> None:
    """``fn(dst, *srcs)``, an in-place write into ``dst`` from the tensors
    ``srcs`` (each a ``(tensor, {dst dim: src dim})`` pair).  With ``dst`` a
    DTensor, ``fn`` runs on this rank's shard of ``dst``: each src is first
    redistributed so that its mapped dims are split as ``dst``'s are and its
    other dims are whole, and ``fn`` gets the local tensors and, as the
    keyword ``offsets``, the global offset of ``dst``'s shard along each of
    its dims.  Plain ``dst``: ``fn`` runs on the tensors as they are, with
    ``offsets`` all 0."""
    if not isinstance(dst, DTensor):
        fn(dst, *[t for t, _ in srcs], offsets=(0,) * dst.ndim)
        return
    mesh = dst.device_mesh
    local = []
    for t, dims in srcs:
        want = tuple(Shard(dims[pl.dim]) if isinstance(pl, Shard) and pl.dim in dims
                     else Replicate() for pl in dst.placements)
        local.append(distribute(t, mesh, ()).redistribute(mesh, want).to_local())
    fn(dst.to_local(), *local, offsets=tuple(local_offset(dst, d) for d in range(dst.ndim)))


def coordinate(axis: str) -> int:
    """This rank's index along mesh axis ``axis`` of the installed mesh (0
    without a mesh, or when the mesh has no such axis)."""
    mesh = _CTX["mesh"]
    if mesh is None or axis not in axis_names(mesh):
        return 0
    return mesh.get_local_rank(axis)


@contextmanager
def replicating():
    """Plain tensors that meet DTensors count as replicated inside (DTensor's
    ``implicit_replication``, made reentrant: its own exit turns it off
    whatever was on before)."""
    if _CTX["replicating"]:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    _CTX["replicating"] = True
    try:
        with implicit_replication():
            yield
    finally:
        _CTX["replicating"] = False


@contextmanager
def use_mesh(mesh, rules: Optional[dict] = None):
    """Install ``mesh`` and ``ACTIVATION_RULES`` updated by ``rules``.  Inside,
    plain tensors that meet DTensors (positions, masks, a 0-d learning rate:
    the same on every rank) count as replicated."""
    prev = {k: _CTX[k] for k in ("mesh", "rules")}
    _CTX["mesh"] = mesh
    _CTX["rules"] = dict(ACTIVATION_RULES, **(rules or {}))
    try:
        with replicating():
            yield
    finally:
        _CTX.update(prev)
