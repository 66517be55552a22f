"""Bucketed decode steps over the planner-addressed cache (port of
``repro.serving.runner``).

The reference AOT-compiles one decode step per batch-size bucket B in
{1, 2, 4, ..., max_batch}, the CUDA-graph idiom in its own terms.  Here, on
the card, each bucket's step is captured into one CUDA graph and replayed
(``runtime.graphs``): ``n_compiles`` (and the ``runner_compile_total``
counter) count captures and stay flat after ``warmup()``.  ``graphs=False``
runs the same step eagerly, and there a bucket counts once, when first
run.

Each step gathers the running slots' rows of the small per-slot leaves
(positions, page-table rows, and the contiguous K/V or recurrent state rows
in gather mode),
runs the model's decode step, picks the greedy tokens, writes them into
the token buffer and scatters the updated rows back, all inside the graph.
Its inputs are static: the engine's cache and token buffer, updated in
place, and a slot buffer filled before each replay.  Paged
pool leaves (``*_pages``) carry no batch axis: they are never gathered, and
the step updates them in place.  A partial batch is padded to its bucket by
repeating the last running slot.  For most models the duplicated rows
compute identical updates from identical inputs; with MoE they need not:
the pad rows are tokens to the router too, sort after the row they copy and
are dropped first when an expert overflows.  The reference's scatter keeps
the last duplicate, the last pad row; PyTorch's indexed write keeps any one,
on the card and on the CPU.  So after the bucket's rows are written back
(and the greedy tokens), the last slot's row is written once more from the
bucket's last row, and every duplicate slot ends holding the reference's
row.

Under a mesh (the engine's, installed around ``warmup()`` and every step)
the cache leaves are DTensors whose slots no rank splits: the gather and
scatter index their local tensors, a graph binds those, and DTensor's
dispatch runs at capture only.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..models.transformer import Transformer
from ..obs.metrics import get_registry
from ..obs.trace import get_tracer
from ..runtime import graphs as graphs_lib
from ..runtime import mesh_ctx


def bucket_ladder(max_batch: int) -> tuple[int, ...]:
    """Powers of two up to ``max_batch``, plus ``max_batch`` itself."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


def _batch_axis(name: str):
    """Positions and page-table rows are (B, ...); pools (``*_pages``) have
    no batch axis; every per-layer leaf (K/V, ``conv``/``ssm``/``h``) is
    (L, B, ...)."""
    if name.endswith("_pages"):
        return None
    return 0 if name in ("pos", "block_tables") else 1


def _local(leaf, axis: int):
    """``leaf``'s local tensor: a DTensor whose batch ``axis`` no mesh dim
    splits (the engine's slots under a mesh) is indexed shard by shard."""
    from torch.distributed.tensor import Shard
    if any(isinstance(p, Shard) and p.dim == axis for p in leaf.placements):
        raise ValueError("a slot cache under a mesh keeps its batch axis whole")
    return leaf.to_local()


def _index_select(leaf, axis: int, slots: torch.Tensor):
    if not mesh_ctx.is_dtensor(leaf):
        return leaf.index_select(axis, slots)
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(_local(leaf, axis).index_select(axis, slots),
                              leaf.device_mesh, leaf.placements, run_check=False)


def _gather_rows(cache: dict, slots: torch.Tensor) -> dict:
    """Sub-cache of the rows named by ``slots`` (bucket-sized batch)."""
    out = {}
    for name, leaf in cache.items():
        axis = _batch_axis(name)
        out[name] = leaf if axis is None else _index_select(leaf, axis, slots)
    return out


def _scatter_rows(cache: dict, sub: dict, slots: torch.Tensor) -> None:
    """Write the updated sub-cache rows back into the full batch cache; the
    last slot (the one padding repeats) gets the bucket's last row."""
    last = slots[-1:]
    for name, leaf in cache.items():
        axis = _batch_axis(name)
        if axis is None:
            continue                    # pools were updated in place by the step
        rows = sub[name]
        if mesh_ctx.is_dtensor(leaf):
            rows = rows.redistribute(leaf.device_mesh, leaf.placements).to_local()
            leaf = _local(leaf, axis)
        if axis == 1:
            leaf[:, slots] = rows
            leaf[:, last] = rows[:, -1:]
        else:
            leaf[slots] = rows
            leaf[last] = rows[-1:]


class DecodeRunner:
    """Ladder of decode steps over batch-size buckets.

    ``step(params, cache, tokens, slots)`` selects the smallest bucket that
    fits ``len(slots)``, pads by repeating the last slot, and replays the
    bucket's graph against the full cache.  With ``warmup()`` called once,
    ``n_compiles`` (and the ``runner_compile_total`` registry counter) stay
    flat no matter how admissions, finishes and preemptions churn the batch.
    """

    def __init__(self, model: Transformer, *, max_batch: int,
                 graphs: Optional[bool] = None):
        """``graphs`` is the counterpart of the reference's ``donate``:
        None means capture CUDA graphs when the model lies on a CUDA device;
        False runs the same static-buffer step eagerly (the CPU, and the
        eager side of an A/B); True on another device raises."""
        self.model = model
        self.max_batch = max_batch
        self.buckets = bucket_ladder(max_batch)
        self.graphs = graphs_lib.use_graphs(graphs, model.device)
        self.n_compiles = 0
        self._warm: set[int] = set()        # buckets run eagerly at least once
        self._graphs: dict[int, graphs_lib.StepGraph] = {}
        self._pool = torch.cuda.graph_pool_handle() if self.graphs else None
        # the slot buffer the step reads, and the host buffer that fills it
        self._slots = torch.zeros(max_batch, dtype=torch.long, device=model.device)
        self._slots_host = np.zeros(max_batch, np.int64)
        # a list to time each replay on the device (CUDA event pairs), or None
        self.replay_events: Optional[list] = None

    # -- the step ------------------------------------------------------------------
    @torch.no_grad()
    def _step_fn(self, params, cache, tokens, slots: torch.Tensor):
        sub = _gather_rows(cache, slots)
        logits, new_sub = self.model.decode_step(params, sub, tokens[slots])
        logits = mesh_ctx.whole(logits)         # under a mesh: every rank's
        # greedy selection and the token-buffer update stay on the device;
        # only the (bucket,) next tokens travel to the host
        nxt = logits.argmax(dim=-1).to(torch.int32)
        tokens[slots] = nxt
        tokens[slots[-1:]] = nxt[-1:]
        _scatter_rows(cache, new_sub, slots)
        return logits, nxt

    def _note_compile(self, bucket: int) -> None:
        """A capture (eagerly: a bucket's first run): count it."""
        self.n_compiles += 1
        reg = get_registry()
        if reg is not None:
            reg.counter("runner_compile_total",
                        "decode-runner bucket (re)compilations").inc()
        t = get_tracer()
        if t is not None:
            t.instant("compile", "serving", track="runner", bucket=bucket,
                      total=self.n_compiles)

    # -- bucket management --------------------------------------------------------
    def bucket_for(self, n: int) -> int:
        """Smallest bucket that fits ``n`` running requests."""
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(f"{n} running requests exceed every bucket "
                         f"{self.buckets}")

    def _load_slots(self, slots: Sequence[int], bucket: int) -> torch.Tensor:
        """The padded slot list in the static buffer's first ``bucket``
        entries.  The copy is blocking, so the host buffer may be rewritten
        as soon as it returns."""
        host = self._slots_host
        host[:len(slots)] = slots
        host[len(slots):bucket] = slots[-1]
        dev = self._slots[:bucket]
        dev.copy_(torch.from_numpy(host[:bucket]))
        return dev

    def _first_run(self, bucket: int) -> None:
        """Eagerly, a bucket's first run is its compile."""
        if bucket not in self._warm:
            self._warm.add(bucket)
            if not self.graphs:
                self._note_compile(bucket)

    def _warm_eager(self, params, cache, tokens, buckets) -> None:
        """Run ``buckets`` once eagerly against a throwaway zeroed cache, so
        first-call costs (cuBLAS handles, kernel builds, allocator growth)
        are paid before serving and outside any capture."""
        dummy = {k: torch.zeros_like(v) for k, v in cache.items()}
        dummy_tokens = torch.zeros_like(tokens)
        for b in buckets:
            self._step_fn(params, dummy, dummy_tokens, self._load_slots([0], b))
            self._first_run(b)

    def _capture(self, bucket: int, params, cache, tokens):
        if bucket not in self._warm:
            self._warm_eager(params, cache, tokens, [bucket])
        self._graphs.pop(bucket, None)      # its pool blocks go back first
        slots = self._slots[:bucket]
        g = self._graphs[bucket] = graphs_lib.StepGraph(
            lambda: self._step_fn(params, cache, tokens, slots), params=params,
            tensors=[*cache.values(), tokens], pool=self._pool)
        self._note_compile(bucket)
        return g

    def warmup(self, params, cache, tokens) -> int:
        """Make every bucket ready before serving; returns the compile count.

        Run each bucket once eagerly against a throwaway zeroed cache; with
        graphs then capture each, largest first (the smaller ones reuse the
        shared pool's memory), against the real cache's addresses.  A
        capture executes nothing, so the real cache is left as it was."""
        self._warm_eager(params, cache, tokens,
                         [b for b in self.buckets if b not in self._warm])
        if not self.graphs:
            return self.n_compiles
        bound = [*cache.values(), tokens]
        for b in reversed(self.buckets):
            g = self._graphs.get(b)
            if g is None or not g.binds(params, bound):
                self._capture(b, params, cache, tokens)
        return self.n_compiles

    # -- the hot path -------------------------------------------------------------
    def step(self, params, cache, tokens, slots: Sequence[int]):
        """One decode step for the rows in ``slots`` (any count <= max_batch).

        Returns ``(logits, cache)`` with ``logits[i]`` the next-token logits
        for ``slots[i]`` (a copy: the next replay overwrites the graph's own);
        rows outside ``slots`` are untouched.  ``tokens`` (the (max_batch,)
        token buffer) gets the greedy picks in place.
        """
        n = len(slots)
        if n == 0:
            return torch.zeros((0, self.model.cfg.padded_vocab)), cache
        logits, _ = self._run(params, cache, tokens, slots)
        return logits[:n].clone(), cache

    def step_greedy(self, params, cache, tokens, slots: Sequence[int]):
        """Engine hot path: one decode step plus greedy pick.

        Returns ``(next_tokens, tokens, cache)`` where ``next_tokens[i]`` is
        the argmax token for ``slots[i]`` (a host numpy array — one blocking
        (bucket,)-int transfer) and ``tokens`` is the (max_batch,) token
        buffer, updated in place."""
        n = len(slots)
        if n == 0:
            return np.zeros(0, np.int32), tokens, cache
        _, nxt = self._run(params, cache, tokens, slots)
        return nxt.cpu().numpy()[:n], tokens, cache

    def _run(self, params, cache, tokens, slots):
        bucket = self.bucket_for(len(slots))
        if not self.graphs:
            self._first_run(bucket)
            return self._step_fn(params, cache, tokens,
                                 self._load_slots(slots, bucket))
        g = self._graphs.get(bucket)
        if g is None or not g.binds(params, [*cache.values(), tokens]):
            # another cache or token buffer than the graph's: capture again
            g = self._capture(bucket, params, cache, tokens)
        self._load_slots(slots, bucket)
        if self.replay_events is None:
            return g.replay()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = g.replay()
        end.record()
        self.replay_events.append((start, end))
        return out

    def stats(self) -> dict:
        return {"buckets": list(self.buckets),
                "n_compiled": len(self._graphs if self.graphs else self._warm),
                "n_compiles": self.n_compiles,
                "graphs": self.graphs,
                "graph_pool_bytes": (graphs_lib.pool_bytes(self._pool)
                                     if self.graphs else 0)}
