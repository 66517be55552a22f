"""Dynamic Storage Allocation (DSA) problem definition + plan validation.

Paper §3.1: given blocks with fixed lifetimes and sizes, assign offsets
``x_i`` so that no two lifetime-overlapping blocks share address space and the
peak ``u = max_i (x_i + w_i)`` is minimized.  NP-hard (Garey & Johnson).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Optional

from .events import Block, MemoryProfile


@dataclass
class AllocationPlan:
    """Solution to one DSA instance: offset per block id + resulting peak."""

    offsets: dict[int, int]            # bid -> x_i (bytes)
    peak: int                          # u (bytes)
    solver: str = "bestfit"
    proven_optimal: bool = False
    stats: dict = field(default_factory=dict)

    def offset(self, bid: int) -> int:
        return self.offsets[bid]


class PlanValidationError(AssertionError):
    pass


def validate_plan(profile: MemoryProfile, plan: AllocationPlan,
                  max_memory: Optional[int] = None) -> None:
    """Check the paper's constraints (2)-(6) hold for ``plan``.

    Raises PlanValidationError on the first violated constraint.  Runs a sweep
    over start-sorted blocks, so it is O(n log n + k) for k colliding pairs.
    """
    bs = profile.blocks
    for b in bs:
        if b.size == 0:
            continue
        x = plan.offsets.get(b.bid)
        if x is None:
            raise PlanValidationError(f"block {b.bid} has no offset")
        if x < 0:
            raise PlanValidationError(f"block {b.bid}: negative offset {x}")
        if x + b.size > plan.peak:
            raise PlanValidationError(
                f"block {b.bid}: top {x + b.size} exceeds declared peak {plan.peak}")
        if max_memory is not None and x + b.size > max_memory:
            raise PlanValidationError(
                f"block {b.bid}: top {x + b.size} exceeds max memory W={max_memory}")

    # Non-overlap for colliding pairs (paper constraints (3)-(4)).
    order = sorted((b for b in bs if b.size > 0), key=lambda b: b.start)
    active: list[Block] = []
    for b in order:
        active = [a for a in active if a.end > b.start]
        xb = plan.offsets[b.bid]
        for a in active:
            xa = plan.offsets[a.bid]
            if not (xa + a.size <= xb or xb + b.size <= xa):
                raise PlanValidationError(
                    f"blocks {a.bid} and {b.bid} overlap in time "
                    f"[{max(a.start, b.start)}, {min(a.end, b.end)}) and in address "
                    f"space [{max(xa, xb)}, {min(xa + a.size, xb + b.size)})")
        active.append(b)

    # Declared peak must match the actual maximum top.
    actual = max((plan.offsets[b.bid] + b.size for b in bs if b.size > 0), default=0)
    if actual != plan.peak:
        raise PlanValidationError(
            f"declared peak {plan.peak} != actual max top {actual}")


def plan_quality(profile: MemoryProfile, plan: AllocationPlan) -> dict:
    """Report peak vs. the liveness lower bound and the naive/total baselines."""
    lb = profile.liveness_lower_bound()
    return {
        "peak": plan.peak,
        "lower_bound": lb,
        "gap_ratio": (plan.peak / lb) if lb else 1.0,
        "naive_total": profile.total_bytes,
        "saving_vs_naive": 1.0 - (plan.peak / profile.total_bytes) if profile.total_bytes else 0.0,
        "solver": plan.solver,
        "proven_optimal": plan.proven_optimal,
    }
