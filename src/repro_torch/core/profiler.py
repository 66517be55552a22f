"""Runtime memory-event recorder (paper §4.1) with interrupt/resume (§4.3).

Maintains the paper's two globals per recorder instance: the event clock ``y``
(incremented after every alloc and free) and the block counter ``lambda``.
Used for the dynamic paths JAX does not statically plan: host staging buffers,
the serving arena, and the paper-native replay benchmarks.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

from .events import DEFAULT_ALIGNMENT, Block, MemoryProfile, align


@dataclass
class _Open:
    bid: int
    size: int
    start: int
    tag: str


class MemoryRecorder:
    """Records alloc/free events into a MemoryProfile."""

    def __init__(self, alignment: int = DEFAULT_ALIGNMENT):
        self.alignment = alignment
        self.y = 1              # event clock (paper's y)
        self.lam = 1            # next block id (paper's lambda)
        self._open: dict[int, _Open] = {}
        self._closed: list[Block] = []
        self._interrupted = 0   # nesting depth of interrupt()
        self.skipped = 0        # events ignored while interrupted

    # -- §4.1 monitoring --------------------------------------------------------
    def on_alloc(self, size: int, tag: str = "") -> int:
        """Record a request; returns the block id (lambda value)."""
        if self._interrupted:
            self.skipped += 1
            return -1
        bid = self.lam
        self._open[bid] = _Open(bid=bid, size=align(size, self.alignment),
                                start=self.y, tag=tag)
        self.lam += 1
        self.y += 1
        return bid

    def on_free(self, bid: int) -> None:
        if bid < 0 or self._interrupted:
            self.skipped += 1
            return
        o = self._open.pop(bid, None)
        if o is None:
            return
        self._closed.append(Block(bid=o.bid, size=o.size, start=o.start,
                                  end=self.y, tag=o.tag))
        self.y += 1

    # -- §4.3 interrupt/resume --------------------------------------------------
    def interrupt(self) -> None:
        self._interrupted += 1

    def resume(self) -> None:
        if self._interrupted == 0:
            raise RuntimeError("resume() without matching interrupt()")
        self._interrupted -= 1

    @contextmanager
    def non_hot(self):
        """Context manager marking a non-hot region (excluded from packing)."""
        self.interrupt()
        try:
            yield
        finally:
            self.resume()

    def stats(self) -> dict:
        """Recorder counters, including events dropped while interrupted
        (``skipped`` was previously recorded but never surfaced)."""
        return {
            "clock": self.y,
            "next_bid": self.lam,
            "n_open": len(self._open),
            "n_closed": len(self._closed),
            "skipped": self.skipped,
            "interrupt_depth": self._interrupted,
        }

    # -- finish -------------------------------------------------------------------
    def finish(self, meta: dict | None = None) -> MemoryProfile:
        """Close any still-open blocks at the current clock and emit the profile."""
        for o in list(self._open.values()):
            self._closed.append(Block(bid=o.bid, size=o.size, start=o.start,
                                      end=self.y, tag=o.tag))
            self.y += 1
        self._open.clear()
        blocks = sorted(self._closed, key=lambda b: b.bid)
        return MemoryProfile(blocks=blocks, clock_end=self.y,
                             meta=dict(meta or {}, skipped=self.skipped))
