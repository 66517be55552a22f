"""CUDA graphs of the decode and padded prefill steps: the port's
counterpart of the reference's AOT-compiled executables.

A step captured once into a CUDA graph replays its kernels with no Python
and no per-op launch cost.  The graph reads and writes the addresses of the
tensors it was captured with, so a ``StepGraph`` is bound to them: the
parameters by identity, every other tensor by ``data_ptr()`` and shape.  A
DTensor (a wrapper without storage of its own) is bound by its local
tensor's: a leaf placed anew holds a new local tensor and captures again.
A caller with other tensors must capture again; replaying would read stale
memory.  The bound tensors are held for the graph's life, so their
addresses cannot be handed to another tensor meanwhile.

Under a mesh DTensor's sharding propagation and ``local_map`` run in Python
at capture only; a replay runs the local kernels (and, on a mesh that
splits a tensor, the collectives) they launched.

A capture executes nothing, so capturing against live state (the engine's
cache) leaves it as it was.  Lazy first-call work (cuBLAS handles, kernel
builds, allocator growth) must have run eagerly before the first capture.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..kernels.ops import CapturedLaunches


def use_graphs(graphs: Optional[bool], device: torch.device) -> bool:
    """Resolve a ``graphs`` option: None means capture on a CUDA device;
    True on another device raises ``ValueError``."""
    cuda = device.type == "cuda"
    if graphs and not cuda:
        raise ValueError(f"graphs=True needs a model on a CUDA device, not {device}")
    return cuda if graphs is None else graphs


def _signature(tensors: Sequence[torch.Tensor]) -> list:
    """``(data_ptr, shape)`` of each tensor; of a DTensor's local tensor."""
    from torch.distributed.tensor import DTensor
    local = [t.to_local() if isinstance(t, DTensor) else t for t in tensors]
    return [(t.data_ptr(), t.shape) for t in local]


class StepGraph:
    """``fn()`` captured into one CUDA graph in the memory pool ``pool``.

    ``out`` is what ``fn`` returned at capture: static tensors that every
    ``replay()`` overwrites.  The kernel wrappers' launch counters move by
    the captured launches on each replay, and not at capture."""

    def __init__(self, fn: Callable, *, params, tensors: Sequence[torch.Tensor],
                 pool):
        self.params = params
        self.tensors = list(tensors)
        self._sig = _signature(self.tensors)
        self.graph = torch.cuda.CUDAGraph()
        with CapturedLaunches() as self.launches:
            with torch.cuda.graph(self.graph, pool=pool):
                self.out = fn()

    def binds(self, params, tensors: Sequence[torch.Tensor]) -> bool:
        """Whether a call with these tensors may replay this graph."""
        return params is self.params and _signature(tensors) == self._sig

    def replay(self):
        self.graph.replay()
        self.launches.replayed()
        return self.out


def pool_bytes(pool) -> int:
    """Device bytes held by the graph memory pool ``pool`` (a
    ``torch.cuda.graph_pool_handle()``): the segments the caching allocator
    reserved for it."""
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == tuple(pool))
