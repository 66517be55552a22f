"""Aten-graph analysis for the roofline terms (the port's counterpart of
``repro.launch.hlo_analysis``).

The reference reads the compiled step's HLO text; the port has none, so
this module reads the ``torch.fx.GraphModule`` that ``core.liveness.trace``
makes of the step on fake tensors, with the liveness module's own helpers:

  * dot FLOPs        — 2 * prod(result dims) * K over the mm / bmm / addmm /
                       baddbmm nodes (``liveness._MATMULS``, ``_node_flops``);
  * HBM bytes        — per node: the bytes of each distinct operand plus
                       the bytes of its results, the reference's model ("op
                       boundaries are HBM round trips"): in eager PyTorch
                       every aten op is a launch of its own.  A view (a
                       return that aliases an input without writing it:
                       ``view``, ``t``, ``expand``, ``split``) launches
                       nothing and counts 0.  An op that writes in place
                       counts what it touches: ``add_`` reads and writes
                       its destination, ``copy_`` only writes it, and a
                       scatter (``index_put_``, ``scatter_add_``: a cache
                       row, an expert's slots) reads its indices and values
                       and writes as many elements of the destination, the
                       reference's rule for ``dynamic-update-slice`` (~2x
                       the update, not the buffer);
  * collective bytes — the wire bytes per device of each functional
                       collective DTensor issued over a mesh
                       (``_c10d_functional``; ``_dtensor.shard_dim_alltoall``
                       on a CUDA mesh), by the reference's ring estimates
                       (``hlo_analysis._coll_wire_bytes``), with g the size
                       of the collective's group: an all-gather moves its
                       result x (g-1)/g, an all-reduce 2 x its size x
                       (g-1)/g, a reduce-scatter its operand x (g-1)/g, an
                       all-to-all its result x (g-1)/g, a send, a receive or
                       a broadcast its size.  ``wait_tensor`` moves nothing
                       and aliases the collective's result.  A collective is
                       an op like any other for the HBM bytes too (it reads
                       its operand and writes its result), as the
                       reference's top-level op rule counts it.  0 on one
                       card.

A Python loop unrolls in the trace, so there is no loop to multiply:
``n_while`` is 0 and ``trips`` is empty.
"""
from __future__ import annotations

import operator
from dataclasses import dataclass, field

import torch

from ..core.liveness import (_MATMULS, _aliased_input, _nbytes, _node_flops, _op_name,
                             _outputs, _ret)


@dataclass
class GraphSummary:
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_bytes_by_kind: dict = field(default_factory=dict)
    coll_counts: dict = field(default_factory=dict)
    n_while: int = 0
    trips: dict = field(default_factory=dict)


def _value_bytes(node) -> int:
    return sum(_nbytes(t) for _, t in _outputs(node.meta.get("val")))


# in-place ops that write their destination without reading it, and
# scatters, which touch it only where their values go
_OVERWRITES = {"copy_", "fill_", "zero_"}
_SCATTERS = {"index_put_", "index_copy_", "index_add_", "scatter_", "scatter_add_",
             "scatter_reduce_", "masked_scatter_"}


def _aliases(node) -> list:
    """``(aliased input, writes)`` of each of the node's returns that
    aliases an input (read as ``liveness`` reads aliases)."""
    out = []
    for i, _ in _outputs(node.meta.get("val")):
        ret = _ret(node, i)
        base = _aliased_input(node, ret) if ret is not None else None
        if base is not None:
            out.append((base, ret.alias_info is not None and ret.alias_info.is_write))
    return out


def _node_hbm_bytes(node) -> float:
    if node.target is operator.getitem:
        return 0.0
    aliases = _aliases(node)
    if any(not writes for _, writes in aliases):
        return 0.0                                         # a view
    result = _value_bytes(node)
    dest = aliases[0][0] if aliases else None
    others = [a for a in node.all_input_nodes if a is not dest]
    read = sum(_value_bytes(a) for a in others)
    name = _op_name(node.target)
    if dest is None or name not in _OVERWRITES | _SCATTERS:
        return float(result + read + (_value_bytes(dest) if dest is not None else 0))
    if name in _SCATTERS:
        elems = max((t.numel() for a in others for _, t in _outputs(a.meta.get("val"))),
                    default=0)
        size = next((t.element_size() for _, t in _outputs(node.meta.get("val"))), 0)
        return float(read + elems * size)
    return float(read + result)


# functional collectives -> the reference's kinds (``hlo_analysis``)
COLLECTIVES = {
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_dtensor::shard_dim_alltoall": "all-to-all",
    "_c10d_functional::broadcast": "collective-permute",
    "_c10d_functional::isend": "collective-permute",
    "_c10d_functional::irecv": "collective-permute",
    "_c10d_functional::batch_p2p_ops": "collective-permute",
}


def _arg(node, name: str):
    for i, a in enumerate(node.target._schema.arguments):
        if a.name == name:
            return node.args[i] if i < len(node.args) else node.kwargs.get(name)
    return None


def group_size(node) -> int:
    """The size of a collective node's group: its ``group_size`` argument
    where the op carries one, else its group name resolved to the process
    group."""
    g = _arg(node, "group_size")
    if g is not None:
        return int(g)
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(_arg(node, "group_name")).size()


def coll_wire_bytes(node) -> tuple:
    """``(kind, wire bytes per device)`` of a collective node, or None for
    any other node."""
    if not isinstance(node.target, torch._ops.OpOverload):
        return None
    kind = COLLECTIVES.get(node.target._schema.name)
    if kind is None:
        return None
    result = _value_bytes(node)
    operand = sum(_value_bytes(a) for a in node.all_input_nodes)
    if kind == "collective-permute":
        return kind, float(result)
    g = group_size(node)
    share = (g - 1) / max(g, 1)
    if kind == "all-reduce":
        return kind, 2.0 * result * share
    if kind == "reduce-scatter":
        return kind, operand * share
    return kind, result * share                 # all-gather, all-to-all


def analyze(gm: torch.fx.GraphModule) -> GraphSummary:
    s = GraphSummary()
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        if isinstance(node.target, torch._ops.OpOverload) and _op_name(node.target) in _MATMULS:
            s.dot_flops += _node_flops(node)
        s.hbm_bytes += _node_hbm_bytes(node)
        coll = coll_wire_bytes(node)
        if coll is not None:
            kind, wire = coll
            s.coll_bytes += wire
            s.coll_bytes_by_kind[kind] = s.coll_bytes_by_kind.get(kind, 0.0) + wire
            s.coll_counts[kind] = s.coll_counts.get(kind, 0) + 1
    return s
