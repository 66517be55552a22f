"""Exact DSA solver — branch-and-bound stand-in for the paper's CPLEX runs
(copy of ``repro.core.exact``).

Searches down-justified packings: in any optimal solution pushed "down" as far
as possible, every block sits at offset 0 or on the top of some
lifetime-overlapping block.  Branching over (next block, candidate offset)
with the liveness lower bound and the incumbent (seeded by best-fit) for
pruning is therefore complete.  Practical for the small instances the paper
solved exactly (it reports CPLEX succeeded on only two configurations).
"""
from __future__ import annotations

import time as _time

from .bestfit import best_fit
from .dsa import AllocationPlan
from .events import MemoryProfile


def solve_exact(profile: MemoryProfile, node_limit: int = 500_000,
                time_limit_s: float = 60.0) -> AllocationPlan:
    """Exact (within node/time limits) minimal-peak plan.

    Returns proven_optimal=True only if the search space was exhausted.
    """
    t_begin = _time.perf_counter()
    blocks = [b for b in profile.blocks if b.size > 0]
    zero_offsets = {b.bid: 0 for b in profile.blocks if b.size == 0}
    incumbent = best_fit(profile)
    if not blocks:
        return AllocationPlan(offsets=zero_offsets, peak=0, solver="exact",
                              proven_optimal=True)

    lb = profile.liveness_lower_bound()
    if incumbent.peak == lb:
        # Heuristic already matches the lower bound: provably optimal.
        return AllocationPlan(offsets=dict(incumbent.offsets), peak=incumbent.peak,
                              solver="exact", proven_optimal=True,
                              stats={"nodes": 0, "seconds": 0.0, "via": "bestfit==lb"})

    n = len(blocks)
    # Precompute lifetime-overlap adjacency.
    overlaps = [[False] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1, n):
            if blocks[i].overlaps(blocks[j]):
                overlaps[i][j] = overlaps[j][i] = True

    best_peak = incumbent.peak
    best_offsets = {b.bid: incumbent.offsets[b.bid] for b in blocks}
    nodes = 0
    exhausted = True

    placed_off = [-1] * n          # offset per block index, -1 = unplaced
    order_sorted = sorted(range(n), key=lambda i: (-blocks[i].size, blocks[i].start))

    def candidates(i: int) -> list[int]:
        """Down-justified candidate offsets for block i, deduped + feasible."""
        cands = {0}
        for j in range(n):
            if placed_off[j] >= 0 and overlaps[i][j]:
                cands.add(placed_off[j] + blocks[j].size)
        out = []
        for x in sorted(cands):
            top = x + blocks[i].size
            if top >= best_peak:        # cannot improve incumbent
                break
            ok = True
            for j in range(n):
                if placed_off[j] >= 0 and overlaps[i][j]:
                    xj, wj = placed_off[j], blocks[j].size
                    if not (xj + wj <= x or top <= xj):
                        ok = False
                        break
            if ok:
                out.append(x)
        return out

    def dfs(num_placed: int, cur_peak: int) -> None:
        nonlocal nodes, best_peak, best_offsets, exhausted
        nodes += 1
        if nodes > node_limit or (_time.perf_counter() - t_begin) > time_limit_s:
            exhausted = False
            return
        if cur_peak >= best_peak or max(cur_peak, lb) >= best_peak:
            return
        if num_placed == n:
            best_peak = cur_peak
            best_offsets = {blocks[i].bid: placed_off[i] for i in range(n)}
            return
        for i in order_sorted:
            if placed_off[i] >= 0:
                continue
            for x in candidates(i):
                placed_off[i] = x
                dfs(num_placed + 1, max(cur_peak, x + blocks[i].size))
                placed_off[i] = -1
                if not exhausted:
                    return
            # NOTE: we must branch over *which* block is placed next, not fix
            # one — completeness of the down-justified argument needs the
            # support order to be discoverable.  So: do not break here unless
            # the instance is trivially separable.
        return

    dfs(0, 0)
    return AllocationPlan(
        offsets={**best_offsets, **zero_offsets},
        peak=best_peak,
        solver="exact",
        proven_optimal=exhausted or best_peak == lb,
        stats={"nodes": nodes, "seconds": _time.perf_counter() - t_begin,
               "lower_bound": lb, "bestfit_peak": incumbent.peak},
    )
