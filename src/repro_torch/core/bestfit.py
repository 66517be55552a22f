"""Best-fit heuristic for DSA (paper §3.2, after Burke et al. 2004).

The x-axis is (fixed) time, the y-axis is the memory offset.  The skyline is a
list of *offset lines*: maximal time segments ``[t0, t1)`` currently topped at
height ``h``.  The algorithm repeats:

  1. choose the lowest offset line (leftmost on ties);
  2. among unplaced blocks whose lifetime fits inside the line's span, place
     the one with the longest lifetime at that offset;
  3. if none fits, *lift up*: merge the line into its lowest adjacent line
     (into both neighbors when their heights are equal).

Complexity is quadratic in the number of blocks (as stated in the paper); the
implementation keeps a lazy min-heap over lines and a start-sorted index over
unplaced blocks so the common case is much cheaper.
"""
from __future__ import annotations

import heapq
import time as _time
from bisect import bisect_left, bisect_right

from .dsa import AllocationPlan
from .events import MemoryProfile


class _Line:
    """One offset line (mutable; dead lines are flagged and skipped)."""

    __slots__ = ("t0", "t1", "h", "alive")

    def __init__(self, t0: int, t1: int, h: int):
        self.t0, self.t1, self.h = t0, t1, h
        self.alive = True


def best_fit(profile: MemoryProfile, *,
             warm_start: tuple[MemoryProfile, AllocationPlan] | None = None,
             ) -> AllocationPlan:
    """Run the best-fit heuristic; returns a validated-shape AllocationPlan.

    ``warm_start=(prev_profile, prev_plan)`` switches to the incremental
    path: blocks whose rectangle (size, start, end) is unchanged from
    ``prev_profile`` keep their ``prev_plan`` offset and only the changed
    blocks are re-placed (see ``incremental_fit``).
    """
    if warm_start is not None:
        prev_profile, prev_plan = warm_start
        return incremental_fit(profile, prev_profile, prev_plan)
    t_begin = _time.perf_counter()
    blocks = [b for b in profile.blocks if b.size > 0]
    offsets: dict[int, int] = {b.bid: 0 for b in profile.blocks if b.size == 0}
    if not blocks:
        return AllocationPlan(offsets=offsets, peak=0, solver="bestfit",
                              stats={"seconds": 0.0, "lifted": 0,
                                     "lines_peak": 0, "heap_pushes": 0})

    tmin = min(b.start for b in blocks)
    tmax = max(b.end for b in blocks)

    # Start-sorted index over unplaced blocks for fast candidate lookup.
    by_start = sorted(blocks, key=lambda b: (b.start, -(b.end - b.start), -b.size))
    starts = [b.start for b in by_start]
    placed = [False] * len(by_start)
    n_unplaced = len(by_start)

    # Doubly-linked skyline of offset lines + lazy min-heap keyed (h, t0).
    head = _Line(tmin, tmax, 0)
    prev: dict[int, _Line | None] = {id(head): None}
    nxt: dict[int, _Line | None] = {id(head): None}
    heap: list[tuple[int, int, int, _Line]] = [(0, tmin, 0, head)]
    counter = 1
    lifted = 0
    # Observability for the "common case much cheaper than quadratic" claim:
    # the live-skyline width bounds per-iteration work, heap pushes count the
    # total line churn.
    n_alive = 1
    lines_peak = 1
    heap_pushes = 1

    def push(line: _Line) -> None:
        nonlocal counter, heap_pushes
        heapq.heappush(heap, (line.h, line.t0, counter, line))
        counter += 1
        heap_pushes += 1

    def pop_lowest() -> _Line:
        while True:
            h, t0, _, line = heapq.heappop(heap)
            if line.alive and line.h == h and line.t0 == t0:
                return line

    def find_candidate(line: _Line):
        """Longest-lifetime unplaced block with lifetime inside [t0, t1)."""
        lo = bisect_left(starts, line.t0)
        hi = bisect_right(starts, line.t1 - 1)
        best = None
        best_key = None
        for k in range(lo, hi):
            if placed[k]:
                continue
            b = by_start[k]
            if b.end <= line.t1:
                key = (b.end - b.start, b.size, -b.bid)
                if best_key is None or key > best_key:
                    best, best_key = (k, b), key
        return best

    while n_unplaced:
        line = pop_lowest()
        cand = find_candidate(line)
        if cand is None:
            # Lift up: merge into the lowest adjacent line (both if equal).
            lifted += 1
            p, q = prev[id(line)], nxt[id(line)]
            ph = p.h if p is not None else None
            qh = q.h if q is not None else None
            assert p is not None or q is not None, "single full-span line must fit any block"
            if q is None or (p is not None and ph <= qh):
                target_h = ph
            else:
                target_h = qh
            new_t0 = line.t0
            new_t1 = line.t1
            if p is not None and p.h == target_h:
                p.alive = False
                n_alive -= 1
                new_t0 = p.t0
                p = prev[id(p)]
            if q is not None and q.h == target_h:
                q.alive = False
                n_alive -= 1
                new_t1 = q.t1
                q = nxt[id(q)]
            line.alive = False
            merged = _Line(new_t0, new_t1, target_h)
            prev[id(merged)] = p
            nxt[id(merged)] = q
            if p is not None:
                nxt[id(p)] = merged
            if q is not None:
                prev[id(q)] = merged
            push(merged)
            continue

        k, b = cand
        placed[k] = True
        n_unplaced -= 1
        offsets[b.bid] = line.h

        # Split the line into up to three pieces around the placed block.
        line.alive = False
        p, q = prev[id(line)], nxt[id(line)]
        pieces: list[_Line] = []
        if b.start > line.t0:
            pieces.append(_Line(line.t0, b.start, line.h))
        pieces.append(_Line(b.start, b.end, line.h + b.size))
        if b.end < line.t1:
            pieces.append(_Line(b.end, line.t1, line.h))
        n_alive += len(pieces) - 1
        lines_peak = max(lines_peak, n_alive)
        for piece in pieces:
            prev[id(piece)] = None
            nxt[id(piece)] = None
        for a, c in zip(pieces, pieces[1:]):
            nxt[id(a)] = c
            prev[id(c)] = a
        first, last = pieces[0], pieces[-1]
        prev[id(first)] = p
        nxt[id(last)] = q
        if p is not None:
            nxt[id(p)] = first
        if q is not None:
            prev[id(q)] = last
        for piece in pieces:
            push(piece)

    peak = max((offsets[b.bid] + b.size for b in blocks), default=0)
    return AllocationPlan(
        offsets=offsets, peak=peak, solver="bestfit",
        stats={"seconds": _time.perf_counter() - t_begin, "lifted": lifted,
               "n_blocks": len(blocks), "lines_peak": lines_peak,
               "heap_pushes": heap_pushes},
    )


def incremental_fit(profile: MemoryProfile, prev_profile: MemoryProfile,
                    prev_plan: AllocationPlan) -> AllocationPlan:
    """Warm-started re-fit: keep unchanged rectangles, place only the rest.

    A block *keeps* its previous offset when the same bid had the identical
    rectangle (size, start, end) in ``prev_profile`` — any subset of a valid
    plan stays valid, so kept blocks need no pairwise recheck.  Changed / new
    blocks are placed (largest first) at the lowest offset feasible against
    everything already placed.  This is the §4.3 hot path: a replan after
    decode outruns the profile or an evict stages back touches a handful of
    rectangles, so re-placing only those is much cheaper than a full repack.

    Quality is the caller's concern — see ``refit`` for the guarded wrapper
    that falls back to a full ``best_fit`` when too much changed or the
    incremental peak degrades past tolerance.
    """
    t_begin = _time.perf_counter()
    prev_rects = {b.bid: (b.size, b.start, b.end) for b in prev_profile.blocks}
    offsets: dict[int, int] = {}
    placed: list = []                      # blocks with an offset already fixed
    changed: list = []
    for b in profile.blocks:
        if b.size == 0:
            offsets[b.bid] = 0
            continue
        if (prev_rects.get(b.bid) == (b.size, b.start, b.end)
                and b.bid in prev_plan.offsets):
            offsets[b.bid] = prev_plan.offsets[b.bid]
            placed.append(b)
        else:
            changed.append(b)

    n_kept = len(placed)
    for b in sorted(changed, key=lambda b: (-b.size, b.start, b.bid)):
        busy = sorted((offsets[a.bid], offsets[a.bid] + a.size)
                      for a in placed if a.overlaps(b))
        off = 0
        for lo, hi in busy:
            if off + b.size <= lo:
                break
            off = max(off, hi)
        offsets[b.bid] = off
        placed.append(b)

    peak = max((offsets[b.bid] + b.size for b in placed), default=0)
    return AllocationPlan(
        offsets=offsets, peak=peak, solver="bestfit",
        stats={"seconds": _time.perf_counter() - t_begin, "mode": "incremental",
               "n_kept": n_kept, "n_placed": len(changed),
               "n_blocks": n_kept + len(changed)},
    )


def refit(profile: MemoryProfile, prev_profile: MemoryProfile | None,
          prev_plan: AllocationPlan | None, *,
          solver=None, max_ratio: float = 1.25,
          min_keep_frac: float = 0.5) -> AllocationPlan:
    """Incremental re-fit with a full-repack quality guard.

    Uses ``incremental_fit`` when a previous plan exists and at least
    ``min_keep_frac`` of the rectangles are unchanged; falls back to a full
    solve (``solver``, default ``best_fit``) when the warm start is missing,
    too little survives, or the incremental peak exceeds ``max_ratio`` x
    max(previous peak, liveness lower bound).  ``plan.stats["mode"]`` records
    which path ran.
    """
    full = solver or best_fit
    if prev_profile is None or prev_plan is None:
        plan = full(profile)
        plan.stats.setdefault("mode", "full")
        return plan
    prev_rects = {b.bid: (b.size, b.start, b.end) for b in prev_profile.blocks}
    sized = [b for b in profile.blocks if b.size > 0]
    kept = sum(1 for b in sized
               if prev_rects.get(b.bid) == (b.size, b.start, b.end)
               and b.bid in prev_plan.offsets)
    if not sized or kept < min_keep_frac * len(sized):
        plan = full(profile)
        plan.stats["mode"] = "full"
        return plan
    plan = incremental_fit(profile, prev_profile, prev_plan)
    bar = max_ratio * max(prev_plan.peak, profile.liveness_lower_bound())
    if plan.peak > bar:
        plan = full(profile)
        plan.stats["mode"] = "full"
    return plan

