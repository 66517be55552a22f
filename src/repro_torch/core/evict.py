"""Eviction stub transform (copy of ``repro.core.evict``) — shared by the
greedy search (``remat.search``) and the exact MIP formulation
(``core.mip``).

Evicting a block does not delete its rectangle: the buffer still exists for
one tick while being produced and one tick while being re-materialized
before its final use, so the transform shrinks the rectangle to those two
stubs.  Keeping the transform here (in core, below both consumers) means the
heuristic and the exact solver provably optimize the same objective.
"""
from __future__ import annotations

from .events import Block

# One tick at production, one at re-materialization before the final use.
STUB_TICKS = 1
# A block must live at least this long for stubbing to remove any area.
MIN_EVICT_LIFETIME = 2 * STUB_TICKS + 2


def stub_size(b: Block, steps: int) -> int:
    """Stub width: scan-stacked residuals (``steps > 1``) materialize one
    per-step slice at a time under remat."""
    return max(b.size // max(int(steps), 1), 1)


def evict_block(b: Block, next_bid: int, steps: int = 1) -> list[Block]:
    """Shrink ``b`` to its production + re-materialization stubs.

    The head stub keeps the original bid (so plan offsets stay addressable);
    the tail stub gets a fresh id.  ``steps > 1`` marks a scan-stacked
    residual (``profile.meta["block_steps"]``).  Returns [] for blocks too
    short to evict.
    """
    if b.lifetime < MIN_EVICT_LIFETIME:
        return []
    w = stub_size(b, steps)
    return [
        Block(bid=b.bid, size=w, start=b.start,
              end=b.start + STUB_TICKS, tag=b.tag),
        Block(bid=next_bid, size=w, start=b.end - STUB_TICKS,
              end=b.end, tag=f"{b.tag}:rematerialize"),
    ]
