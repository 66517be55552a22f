"""Reorder-within-slack lifetime compaction (OLLA-style, in front of best-fit).
Copy of ``repro.core.reorder``; the port's ``make_fx`` profile writes the
``op_edges`` the reference's jaxpr profile writes.

The DSA pass so far takes the profiled operator order as given: lifetimes are
fixed rectangles and only *addresses* are optimized.  OLLA (arxiv 2210.12924)
shows that jointly choosing lifetime *and* location beats pure packing: many
operators have scheduling slack — they may legally run earlier or later
without violating any producer/consumer dependency — and shifting them
reshapes the liveness skyline before the rectangles are ever placed.

This module recovers a precedence graph from a ``MemoryProfile``:

  * **ops** are the distinct event-clock ticks at which any block is
    allocated (``b.start``) or last used (``b.end - 1``), plus any tick named
    by recorded dataflow edges;
  * **edges** come from ``profile.meta["op_edges"]`` when the profile was
    traced from a graph (true dataflow: every consumer reads after its
    producer), and always include the per-block producer -> last-consumer
    edge recoverable from the events alone (recorded allocator streams carry
    no dataflow, so that per-block order is all we can soundly assert there).

A *reorder* is a permutation of the ops mapped back onto the same sorted tick
positions, so the clock span and tick vocabulary are preserved and every
topological order yields a profile whose blocks still satisfy the recovered
precedence.  Candidate orders come from a memory-aware list scheduler
(greedy: prefer ready ops that free more bytes than they allocate) refined by
seeded iterated local search; every candidate — including the identity — is
scored by actually packing it with ``best_fit``, and the best profile/plan
pair wins.  Because the identity order is always in the candidate set, the
reordered peak is never worse than the greedy-packing peak.

Soundness note: a reordered plan is a *(schedule, placement)* pair.  Its peak
is achieved only by executing ops in the reordered order; consumers that
replay the original event order (the serving arena) treat it as advisory and
keep their overflow/replan machinery as the safety net — which is why the
serving integrations default to ``reorder=None``.
"""
from __future__ import annotations

import random
import time as _time
from dataclasses import dataclass, field
from typing import Callable, Sequence

from .bestfit import best_fit
from .dsa import AllocationPlan
from .events import Block, MemoryProfile


@dataclass
class PrecedenceGraph:
    """Ops (event-clock ticks) + precedence edges recovered from a profile."""

    ticks: list[int]                       # sorted distinct op ticks
    edges: list[tuple[int, int]]           # (u, v) op-index pairs: u before v
    start_op: dict[int, int]               # bid -> op index of b.start
    end_op: dict[int, int]                 # bid -> op index of b.end - 1
    preds: list[list[int]] = field(default_factory=list)
    succs: list[list[int]] = field(default_factory=list)

    @property
    def n_ops(self) -> int:
        return len(self.ticks)

    # -- recovery --------------------------------------------------------------
    @staticmethod
    def from_profile(profile: MemoryProfile) -> "PrecedenceGraph":
        """Recover ops and precedence from events (+ recorded dataflow edges).

        ``meta["op_edges"]`` (written by ``profile_graph``) is a list of
        ``(producer_tick, consumer_tick)`` pairs; every consumption — not
        just the last — becomes an edge, so chains through intermediate
        consumers are preserved.  Without it (recorded allocator streams)
        only each block's own producer -> last-consumer edge is asserted:
        that recovery is *optimistic* — independent requests may be reordered
        freely — which is exactly the advisory-planning semantics documented
        above.
        """
        tick_set: set[int] = set()
        for b in profile.blocks:
            tick_set.add(b.start)
            tick_set.add(b.end - 1)
        raw_edges = [tuple(e) for e in profile.meta.get("op_edges", [])]
        for u, v in raw_edges:
            tick_set.add(u)
            tick_set.add(v)
        ticks = sorted(tick_set)
        index = {t: i for i, t in enumerate(ticks)}

        edge_set: set[tuple[int, int]] = set()
        for u, v in raw_edges:
            iu, iv = index[u], index[v]
            if iu == iv:
                continue
            if iu > iv:
                # profile_graph always records producer-before-consumer; a
                # backward edge means the dataflow metadata contradicts the
                # event clock — flipping or dropping it would assert a wrong
                # precedence, so refuse to reorder such a profile.
                raise ValueError(
                    f"op_edges claim tick {u} precedes tick {v}, against the "
                    "event clock; dataflow metadata is inconsistent with the "
                    "profile")
            edge_set.add((iu, iv))
        start_op: dict[int, int] = {}
        end_op: dict[int, int] = {}
        for b in profile.blocks:
            s, e = index[b.start], index[b.end - 1]
            start_op[b.bid] = s
            end_op[b.bid] = e
            if s != e:
                edge_set.add((s, e))

        edges = sorted(edge_set)
        preds: list[list[int]] = [[] for _ in ticks]
        succs: list[list[int]] = [[] for _ in ticks]
        for u, v in edges:
            succs[u].append(v)
            preds[v].append(u)
        return PrecedenceGraph(ticks=ticks, edges=edges, start_op=start_op,
                               end_op=end_op, preds=preds, succs=succs)

    # -- slack -----------------------------------------------------------------
    def levels(self) -> tuple[list[int], list[int]]:
        """ASAP / ALAP topological levels per op (unit-weight longest paths)."""
        n = self.n_ops
        asap = [0] * n
        for v in range(n):                   # ops are tick-sorted => topo order
            for u in self.preds[v]:
                asap[v] = max(asap[v], asap[u] + 1)
        depth = max(asap, default=0)
        alap = [depth] * n
        for u in range(n - 1, -1, -1):
            for v in self.succs[u]:
                alap[u] = min(alap[u], alap[v] - 1)
        return asap, alap

    def slack(self) -> list[int]:
        """Per-op scheduling slack (ALAP - ASAP level); 0 = critical path."""
        asap, alap = self.levels()
        return [l - a for a, l in zip(asap, alap)]

    def block_slack(self, profile: MemoryProfile) -> dict[int, tuple[int, int]]:
        """Per-block (start-op slack, end-op slack) in topological levels."""
        s = self.slack()
        return {b.bid: (s[self.start_op[b.bid]], s[self.end_op[b.bid]])
                for b in profile.blocks}

    def check_order(self, order: Sequence[int]) -> bool:
        """True iff ``order`` (a permutation of op indices) respects all edges."""
        pos = [0] * self.n_ops
        for k, o in enumerate(order):
            pos[o] = k
        return all(pos[u] < pos[v] for u, v in self.edges)


def apply_order(profile: MemoryProfile, graph: PrecedenceGraph,
                order: Sequence[int]) -> MemoryProfile:
    """Remap block lifetimes onto the reordered schedule.

    Op at position ``k`` of ``order`` executes at the ``k``-th original tick,
    so the clock span is preserved; each block's lifetime becomes
    ``[tick(pos(start_op)), tick(pos(end_op)) + 1)``.  ``meta["reorder_ticks"]``
    records the original-tick -> new-tick map so an independent checker can
    verify precedence without trusting this module.
    """
    if len(order) != graph.n_ops:
        raise ValueError(f"order has {len(order)} ops, graph has {graph.n_ops}")
    pos = [0] * graph.n_ops
    for k, o in enumerate(order):
        pos[o] = k
    new_tick = [graph.ticks[pos[o]] for o in range(graph.n_ops)]
    blocks = []
    for b in profile.blocks:
        s = new_tick[graph.start_op[b.bid]]
        e = new_tick[graph.end_op[b.bid]] + 1
        blocks.append(Block(bid=b.bid, size=b.size, start=s, end=e, tag=b.tag))
    meta = dict(profile.meta)
    meta["reordered"] = True
    meta["reorder_ticks"] = {graph.ticks[o]: new_tick[o]
                             for o in range(graph.n_ops)}
    return MemoryProfile(blocks=blocks, retained_bytes=profile.retained_bytes,
                         clock_end=profile.clock_end, meta=meta)


def _list_schedule(graph: PrecedenceGraph, alloc: list[int], free: list[int],
                   noise: list[float] | None = None) -> list[int]:
    """Memory-aware list scheduling: ready op maximizing bytes freed - bytes
    allocated runs next (original rank breaks ties, so zero-slack graphs
    reproduce the identity order).  ``noise`` perturbs priorities for ILS."""
    n = graph.n_ops
    indeg = [len(p) for p in graph.preds]
    ready = [o for o in range(n) if indeg[o] == 0]
    order: list[int] = []
    while ready:
        best = None
        best_key = None
        for o in ready:
            prio = float(free[o] - alloc[o])
            if noise is not None:
                prio += noise[o]
            key = (prio, -o)               # tie -> earliest original rank
            if best_key is None or key > best_key:
                best, best_key = o, key
        ready.remove(best)
        order.append(best)
        for v in graph.succs[best]:
            indeg[v] -= 1
            if indeg[v] == 0:
                ready.append(v)
    if len(order) != n:
        raise ValueError("precedence graph has a cycle")
    return order


@dataclass
class ReorderResult:
    """Best (schedule, placement) pair found by the reordering pass."""

    profile: MemoryProfile                 # reordered lifetimes
    plan: AllocationPlan                   # placement for the reordered profile
    order: list[int]                       # winning op permutation
    identity_peak: int                     # best-fit peak on the original order
    graph: PrecedenceGraph
    stats: dict = field(default_factory=dict)

    @property
    def peak(self) -> int:
        return self.plan.peak

    @property
    def improved(self) -> bool:
        return self.plan.peak < self.identity_peak


def reorder_profile(profile: MemoryProfile, *, mode: str = "ils",
                    rounds: int = 8, seed: int = 0,
                    solver: Callable[[MemoryProfile], AllocationPlan] = best_fit,
                    ) -> ReorderResult:
    """Reorder lifetimes within dependency slack, then pack.

    ``mode="greedy"`` evaluates identity + one memory-aware list schedule;
    ``mode="ils"`` adds ``rounds`` seeded noise-perturbed restarts (iterated
    local search), keeping the minimum-peak candidate.  Every candidate is
    packed with ``solver`` and the identity order is always a candidate, so
    ``result.peak <= best_fit(profile).peak``.
    """
    if mode not in ("greedy", "ils"):
        raise ValueError(f"unknown reorder mode {mode!r}")
    t_begin = _time.perf_counter()
    graph = PrecedenceGraph.from_profile(profile)
    identity = list(range(graph.n_ops))
    id_plan = solver(profile)
    best_order, best_prof, best_plan = identity, profile, id_plan
    evaluated = 1

    slack = graph.slack()
    if graph.n_ops > 1 and any(s > 0 for s in slack):
        alloc = [0] * graph.n_ops
        free = [0] * graph.n_ops
        for b in profile.blocks:
            alloc[graph.start_op[b.bid]] += b.size
            free[graph.end_op[b.bid]] += b.size
        scale = max(max(alloc, default=1), max(free, default=1), 1)

        candidates = [_list_schedule(graph, alloc, free)]
        if mode == "ils":
            rng = random.Random(seed)
            for _ in range(max(0, rounds)):
                noise = [rng.uniform(-0.5, 0.5) * scale
                         for _ in range(graph.n_ops)]
                candidates.append(_list_schedule(graph, alloc, free, noise))
        seen = {tuple(identity)}
        for order in candidates:
            key = tuple(order)
            if key in seen:
                continue
            seen.add(key)
            prof = apply_order(profile, graph, order)
            plan = solver(prof)
            evaluated += 1
            if plan.peak < best_plan.peak:
                best_order, best_prof, best_plan = order, prof, plan

    return ReorderResult(
        profile=best_prof, plan=best_plan, order=list(best_order),
        identity_peak=id_plan.peak, graph=graph,
        stats={
            "seconds": _time.perf_counter() - t_begin,
            "n_ops": graph.n_ops,
            "n_edges": len(graph.edges),
            "max_slack": max(slack, default=0),
            "candidates_evaluated": evaluated,
            "mode": mode,
            "improvement": 1.0 - (best_plan.peak / id_plan.peak)
                           if id_plan.peak else 0.0,
        },
    )
