"""Memory-profile datatypes (paper §3.1, §4.1).

A *block* is one memory request observed in a sample run: size ``w_i`` and a
half-open lifetime ``[start, end)`` on the integer event clock ``y``.  A
*profile* is the full set of blocks gathered from one hot region of the
propagation, plus bookkeeping for memory that is retained across the whole run
(weights, optimizer state — the dotted-red bars of the paper's Fig. 2, which
the optimization deliberately leaves alone).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Iterable, Sequence

DEFAULT_ALIGNMENT = 512  # bytes; matches CuPy/Chainer pool rounding.


def align(size: int, alignment: int = DEFAULT_ALIGNMENT) -> int:
    """Round ``size`` up to a multiple of ``alignment`` (0 stays 0)."""
    if size <= 0:
        return 0
    return ((size + alignment - 1) // alignment) * alignment


@dataclass(frozen=True, order=True)
class Block:
    """One profiled memory request (rectangle: lifetime x size)."""

    bid: int          # block id (the paper's lambda counter value)
    size: int         # bytes, already alignment-rounded
    start: int        # request time  y_i   (inclusive)
    end: int          # release time  ybar_i (exclusive)
    tag: str = ""     # provenance (e.g. jaxpr var / op name), debugging only

    def __post_init__(self) -> None:
        if self.end <= self.start:
            raise ValueError(
                f"block {self.bid}: empty/negative lifetime [{self.start}, {self.end})")
        if self.size < 0:
            raise ValueError(f"block {self.bid}: negative size {self.size}")

    @property
    def lifetime(self) -> int:
        return self.end - self.start

    def overlaps(self, other: "Block") -> bool:
        """Lifetime overlap — the paper's possible-colliding-pair predicate."""
        return self.start < other.end and other.start < self.end


@dataclass
class MemoryProfile:
    """A set of blocks from one hot region, plus retained (unpacked) bytes."""

    blocks: list[Block] = field(default_factory=list)
    retained_bytes: int = 0        # weights/optimizer state etc. (not packed)
    clock_end: int = 0             # final value of the event clock y
    meta: dict = field(default_factory=dict)

    # ---- derived quantities -------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.blocks)

    @property
    def total_bytes(self) -> int:
        """Sum of all request sizes = the naive network-wise peak."""
        return sum(b.size for b in self.blocks)

    def liveness_lower_bound(self) -> int:
        """max over time of the sum of live sizes — a valid DSA lower bound."""
        events: list[tuple[int, int]] = []
        for b in self.blocks:
            if b.size == 0:
                continue
            events.append((b.start, b.size))
            events.append((b.end, -b.size))
        events.sort()
        cur = peak = 0
        for _, delta in events:
            cur += delta
            peak = max(peak, cur)
        return peak

    def colliding_pairs(self) -> list[tuple[int, int]]:
        """The paper's set E: index pairs (i, j), i<j, with overlapping lifetimes."""
        bs = self.blocks
        out = []
        order = sorted(range(len(bs)), key=lambda i: bs[i].start)
        active: list[int] = []
        for i in order:
            b = bs[i]
            active = [j for j in active if bs[j].end > b.start]
            for j in active:
                out.append((min(i, j), max(i, j)))
            active.append(i)
        return out

    # ---- (de)serialization ---------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "blocks": [dataclasses.asdict(b) for b in self.blocks],
            "retained_bytes": self.retained_bytes,
            "clock_end": self.clock_end,
            "meta": self.meta,
        })

    @staticmethod
    def from_json(s: str) -> "MemoryProfile":
        d = json.loads(s)
        return MemoryProfile(
            blocks=[Block(**b) for b in d["blocks"]],
            retained_bytes=d["retained_bytes"],
            clock_end=d["clock_end"],
            meta=d.get("meta", {}),
        )


def make_profile(sizes_and_lifetimes: Iterable[tuple[int, int, int]],
                 alignment: int = DEFAULT_ALIGNMENT) -> MemoryProfile:
    """Build a profile from (size, start, end) triples (test/bench helper)."""
    blocks = [
        Block(bid=i, size=align(s, alignment), start=a, end=e)
        for i, (s, a, e) in enumerate(sizes_and_lifetimes)
    ]
    clock_end = max((b.end for b in blocks), default=0)
    return MemoryProfile(blocks=blocks, clock_end=clock_end)
