"""Baseline allocators the paper compares against (§2, §5.1).

* ``PoolAllocator`` — Chainer/CuPy-style dynamic pool: best-fit over a free
  list with 512 B rounding, chunk splitting and buddy-coalescing; on
  exhaustion it frees all unused chunks and falls back to fresh physical
  allocation (the behavior the paper blames for seq2seq slowdowns, §5.3).
* ``NaiveAllocator`` — network-wise allocation: every request takes fresh
  physical memory which is only reclaimed when the iteration ends (the
  paper's 1.50 GB-vs-1.21 GB AlexNet remark).

Both are *simulators*: they model peak physical consumption and per-request
search cost for a replayed MemoryProfile, giving the "orig" bars of Fig. 2/3.
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass, field

from .events import DEFAULT_ALIGNMENT, MemoryProfile, align


@dataclass
class _Chunk:
    offset: int
    size: int
    free: bool
    prev: "_Chunk | None" = field(default=None, repr=False)
    next: "_Chunk | None" = field(default=None, repr=False)


class PoolAllocator:
    """Best-fit memory pool with splitting and coalescing (Chainer-style)."""

    def __init__(self, alignment: int = DEFAULT_ALIGNMENT):
        self.alignment = alignment
        self.physical_top = 0          # total bytes ever claimed from "physical"
        self.head: _Chunk | None = None
        self.tail: _Chunk | None = None
        self.live: dict[int, _Chunk] = {}
        self.search_steps = 0          # proxy for the pool-search latency
        self.n_alloc = 0

    # -- internals -------------------------------------------------------------
    def _grow(self, size: int) -> _Chunk:
        c = _Chunk(offset=self.physical_top, size=size, free=False)
        self.physical_top += size
        if self.tail is None:
            self.head = self.tail = c
        else:
            self.tail.next = c
            c.prev = self.tail
            self.tail = c
        return c

    def _best_fit(self, size: int) -> _Chunk | None:
        best = None
        c = self.head
        while c is not None:
            self.search_steps += 1
            if c.free and c.size >= size and (best is None or c.size < best.size):
                best = c
                if best.size == size:
                    break
            c = c.next
        return best

    # -- public API ------------------------------------------------------------
    def malloc(self, handle: int, size: int) -> int:
        size = align(size, self.alignment)
        self.n_alloc += 1
        if size == 0:
            return 0
        c = self._best_fit(size)
        if c is None:
            c = self._grow(size)
        else:
            c.free = False
            if c.size > size:  # split the remainder back into the free list
                rest = _Chunk(offset=c.offset + size, size=c.size - size, free=True,
                              prev=c, next=c.next)
                if c.next is not None:
                    c.next.prev = rest
                else:
                    self.tail = rest
                c.next = rest
                c.size = size
        self.live[handle] = c
        return c.offset

    def free(self, handle: int) -> None:
        c = self.live.pop(handle, None)
        if c is None:
            return
        c.free = True
        # Coalesce with free neighbors.
        if c.next is not None and c.next.free:
            n = c.next
            c.size += n.size
            c.next = n.next
            if n.next is not None:
                n.next.prev = c
            else:
                self.tail = c
        if c.prev is not None and c.prev.free:
            p = c.prev
            p.size += c.size
            p.next = c.next
            if c.next is not None:
                c.next.prev = p
            else:
                self.tail = p

    @property
    def peak(self) -> int:
        return self.physical_top


class NaiveAllocator:
    """Network-wise allocation: fresh physical memory per request, reclaimed
    only at iteration end (``reset``)."""

    def __init__(self, alignment: int = DEFAULT_ALIGNMENT):
        self.alignment = alignment
        self.cur = 0
        self.peak = 0
        self.n_alloc = 0

    def malloc(self, handle: int, size: int) -> int:
        size = align(size, self.alignment)
        self.n_alloc += 1
        off = self.cur
        self.cur += size
        self.peak = max(self.peak, self.cur)
        return off

    def free(self, handle: int) -> None:  # no reuse within an iteration
        pass

    def reset(self) -> None:
        self.cur = 0


def replay(profile: MemoryProfile, allocator) -> dict:
    """Replay a profile's alloc/free event stream through ``allocator``.

    Returns peak bytes and wall time (the Fig. 3 "allocation latency" proxy).
    """
    events: list[tuple[int, int, int]] = []  # (time, kind 0=alloc/1=free, idx)
    for idx, b in enumerate(profile.blocks):
        events.append((b.start, 0, idx))
        events.append((b.end, 1, idx))
    events.sort()
    t0 = _time.perf_counter()
    for _, kind, idx in events:
        b = profile.blocks[idx]
        if kind == 0:
            allocator.malloc(b.bid, b.size)
        else:
            allocator.free(b.bid)
    dt = _time.perf_counter() - t0
    return {
        "peak": allocator.peak,
        "seconds": dt,
        "per_event_us": 1e6 * dt / max(1, len(events)),
        "n_events": len(events),
        "search_steps": getattr(allocator, "search_steps", 0),
    }
