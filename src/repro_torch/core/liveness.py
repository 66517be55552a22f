"""Static memory profiler: traced aten graph -> MemoryProfile (port of
``repro.core.liveness``).

The paper profiles a *sample run* because Chainer is define-by-run.  The
port traces one propagation with ``make_fx(tracing_mode="fake")``: every
aten op the function (its backward included, when it calls
``torch.autograd.grad``) runs becomes a graph node on fake tensors, so a
full-width step is profiled without allocating anything.  Request time of a
buffer is the index of its producing node, release time follows its last
consuming node, and the size comes from the fake value.  Placeholders
(parameters, optimizer state, the batch) and graph constants are *retained*
memory (Fig. 2's dotted bars) and are excluded from packing.

Which outputs are new buffers is read from the op's schema, not from
storages (fake storages do not identify buffers across a checkpoint's
recompute): a return with ``alias_info`` (views such as ``view``, ``t``,
``expand``, ``slice``, ``detach``; in-place ops such as ``add_``) makes no
block and extends the lifetime of the block it aliases to its own last use.
"""
from __future__ import annotations

import operator
from typing import Callable
from unittest import mock

import torch
import torch.utils.checkpoint as _checkpoint
from torch.fx.experimental.proxy_tensor import make_fx

from .events import DEFAULT_ALIGNMENT, Block, MemoryProfile, align

# Ops that share their input's storage although their schema carries no
# alias annotation: a functional collective's ``wait_tensor`` hands back the
# collective's own result.
_UNANNOTATED_VIEWS = {"_unsafe_view", "wait_tensor"}
_MATMULS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1}     # op -> lhs arg
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
               "logsumexp", "prod", "var", "std", "norm", "any", "all"}


def _outputs(val) -> list[tuple[int, torch.Tensor]]:
    """(index, tensor) of a node's value: a tensor is index 0, a tuple or
    list indexes its entries as ``getitem`` does (``None`` entries skipped)."""
    if isinstance(val, torch.Tensor):
        return [(0, val)]
    if isinstance(val, (list, tuple)):
        return [(i, v) for i, v in enumerate(val) if isinstance(v, torch.Tensor)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _op_name(target) -> str:
    return target._schema.name.split("::")[-1]


def _node_flops(node) -> float:
    """Rough FLOP count for recomputing one node's outputs: the 2*out*K
    matmul count for mm/bmm/addmm/baddbmm, the input size for reductions,
    else one FLOP per output element.  A cost *model*: relative magnitudes
    drive the remat knapsack."""
    name = _op_name(node.target)
    out_elems = sum(t.numel() for _, t in _outputs(node.meta.get("val")))
    if name in _MATMULS:
        lhs = node.args[_MATMULS[name]].meta["val"]
        return 2.0 * out_elems * int(lhs.shape[-1])
    if name in _REDUCTIONS:
        return float(sum(t.numel() for a in node.all_input_nodes
                         for _, t in _outputs(a.meta.get("val"))))
    return float(out_elems)


def _ret(node, idx: int):
    """The schema return of ``node``'s output ``idx`` (a list return, as
    ``split``'s, covers every index), or None for a schema with none."""
    rets = node.target._schema.returns
    return rets[min(idx, len(rets) - 1)] if rets else None


def _aliased_input(node, ret) -> object | None:
    """The input node whose buffer return ``ret`` of ``node`` aliases, or
    None when the return is a new buffer."""
    schema = node.target._schema
    info = ret.alias_info
    if info is None and _op_name(node.target) not in _UNANNOTATED_VIEWS:
        return None
    for i, arg in enumerate(schema.arguments):
        a_info = arg.alias_info
        if info is not None and (a_info is None
                                 or not (a_info.before_set & info.before_set)):
            continue
        val = node.args[i] if i < len(node.args) else node.kwargs.get(arg.name)
        if isinstance(val, (list, tuple)):
            val = val[0] if val else None
        if isinstance(val, torch.fx.Node):
            return val
    return None


def profile_graph(gm: torch.fx.GraphModule, *,
                  alignment: int = DEFAULT_ALIGNMENT) -> MemoryProfile:
    """Liveness analysis over a traced graph's call nodes."""
    calls = [n for n in gm.graph.nodes if n.op == "call_function"]
    n_eqns = len(calls)
    tick = {n: t for t, n in enumerate(calls)}

    # value key (node, output index) -> owning buffer: a block key, or the
    # key of a retained input (a placeholder's or a get_attr's value)
    owner: dict = {}
    inputs: dict = {}                   # retained key -> (node op, bytes)
    for n in gm.graph.nodes:
        if n.op in ("placeholder", "get_attr"):
            val = n.meta.get("val")
            if val is None and n.op == "get_attr":
                val = getattr(gm, n.target, None)
            for i, t in _outputs(val):
                owner[(n, i)] = (n, i)
                inputs[(n, i)] = (n.op, _nbytes(t))

    sizes: dict = {}
    produced_at: dict = {}
    last_use: dict = {}
    tags: dict = {}
    flops: dict = {}
    op_edges: set = set()

    def owner_of(node, idx: int = 0):
        return owner.get((node, idx))

    def owners(node):
        return [owner_of(node, i) for i, _ in _outputs(node.meta.get("val"))]

    for t, n in enumerate(calls):
        for a in n.all_input_nodes:
            if a in tick:
                op_edges.add((2 * tick[a], 2 * t))
            for key in owners(a):
                if key is not None:
                    last_use[key] = t
        if n.target is operator.getitem:
            owner[(n, 0)] = owner_of(n.args[0], n.args[1])
            continue
        if not isinstance(n.target, torch._ops.OpOverload):
            raise TypeError(f"profile_graph: unexpected call target {n.target!r}")
        cost = None
        for i, val in _outputs(n.meta.get("val")):
            ret = _ret(n, i)
            base = _aliased_input(n, ret) if ret is not None else None
            if base is not None:
                key = owner_of(base)
                owner[(n, i)] = key
                if key is not None:
                    last_use[key] = t
                continue
            if cost is None:
                cost = _node_flops(n)
            key = (n, i)
            owner[key] = key
            sizes[key] = _nbytes(val)
            produced_at[key] = t
            last_use[key] = t
            tags[key] = str(n.target)
            flops[key] = cost
    # Outputs of the graph live to the very end.
    out_node = next(n for n in gm.graph.nodes if n.op == "output")
    returned: dict = {}                 # distinct buffers the graph returns
    for a in out_node.all_input_nodes:
        for key in owners(a):
            if key is not None:
                last_use[key] = n_eqns
                returned[key] = inputs[key] if key in inputs else ("block", sizes[key])

    blocks: list[Block] = []
    block_flops: dict[int, float] = {}
    bid = 1
    for key, t_prod in produced_at.items():
        if sizes[key] == 0:
            continue
        # event clock: alloc at 2t, free after last use (2t_last+1), so
        # same-node producer/consumer pairs still overlap
        blocks.append(Block(bid=bid, size=align(sizes[key], alignment),
                            start=2 * t_prod, end=2 * last_use[key] + 1,
                            tag=tags[key]))
        block_flops[bid] = flops[key]
        bid += 1

    return MemoryProfile(
        blocks=blocks,
        retained_bytes=sum(size for _, size in inputs.values()),
        clock_end=2 * n_eqns + 1,
        meta={"n_eqns": n_eqns, "source": "fx", "block_flops": block_flops,
              "block_steps": {},
              "op_edges": sorted([u, v] for u, v in op_edges),
              # retained bytes by kind of input, and each buffer the graph
              # returns as [kind, bytes]: "block" for a new buffer, else the
              # input's kind (a buffer the step hands back, in place or not)
              "input_bytes": {op: sum(size for k, size in inputs.values() if k == op)
                              for op in ("placeholder", "get_attr")},
              "returned": [list(v) for v in returned.values()]},
    )


def trace(fn: Callable, *args) -> torch.fx.GraphModule:
    """``make_fx(fn, tracing_mode="fake")(*args)``: fake inputs (made under
    a ``FakeTensorMode``) keep their mode, real ones are faked, so nothing of
    the traced step is allocated.

    Under make_fx's proxy mode, ``torch.utils.checkpoint``'s selective
    checkpoints take their compile path: they keep every op's output and
    only mark the nodes for AOTAutograd's partitioner, which make_fx does not
    run, so the trace would show no recompute at all.  The profile must show
    what the step does when it runs, so the trace keeps them on their eager
    path (the check is ``torch.utils.checkpoint._is_compiling``)."""
    with mock.patch.object(_checkpoint, "_is_compiling", lambda *a, **k: False):
        return make_fx(fn, tracing_mode="fake")(*args)


def profile_fn(fn: Callable, *args, alignment: int = DEFAULT_ALIGNMENT) -> MemoryProfile:
    """Trace ``fn`` on fake tensors and profile it."""
    prof = profile_graph(trace(fn, *args), alignment=alignment)
    prof.meta["fn"] = getattr(fn, "__name__", str(fn))
    return prof
