"""Eviction selection: greedy area-per-cost knapsack with iterative
replanning (port of ``repro.remat.search``).

Candidates are visited in decreasing packing-area-bought-per-overhead-second
(``BlockCost.benefit``).  Each candidate is *tentatively* evicted — its
rectangle shrinks to two one-tick stubs at production and at the final use
(the buffer still exists momentarily while being written / re-materialized) —
and ``best_fit`` is re-run on the transformed profile.  The eviction is kept
only if the DSA peak actually drops; skyline packing means removing area does
not always lower the peak, so the solver is the oracle, not the area sum.

Two stopping modes:
  * target-peak  — stop once the packed peak is at or under ``target_peak``
    (or ``target_ratio`` x the baseline peak);
  * exhaustive   — no target: keep buying peak reductions until candidates
    run out or ``max_evict`` is hit.

Target-*batch* mode is layered on top by
``MemoryPlanner.max_feasible_batch_planned``: it binary-searches the batch
size, calling this search at each probe with the HBM budget as target peak.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from ..core.bestfit import best_fit
from ..core.dsa import AllocationPlan
from ..core.events import MemoryProfile
# The stub transform lives in core so this search and the exact MIP
# (core/mip.py) provably optimize the same objective.
from ..core.evict import MIN_EVICT_LIFETIME as _MIN_EVICT_LIFETIME
from ..core.evict import evict_block
from ..obs.trace import get_tracer
from .cost_model import CostModel


@dataclass(frozen=True)
class Eviction:
    """One accepted eviction decision."""

    bid: int
    mode: str            # "recompute" | "offload"
    saved_area: int      # bytes x ticks removed from the packing
    cost_s: float        # estimated overhead per step
    tag: str = ""


@dataclass
class EvictionPlan:
    """Output of the search: what to evict, and what it bought."""

    evictions: list[Eviction]
    baseline_peak: int           # packed peak with nothing evicted
    peak: int                    # packed peak after evictions
    overhead_s: float            # summed per-step eviction overhead
    target_peak: Optional[int]   # requested target (None = exhaustive mode)
    plan: AllocationPlan         # offsets for the transformed profile
    profile: MemoryProfile       # the transformed (post-eviction) profile
    meta: dict = field(default_factory=dict)
    #: Profile the plan's offsets are valid against.  Equal to ``profile``
    #: unless the search ran with ``reorder`` and the reordered schedule won,
    #: in which case this holds the reordered lifetimes (``profile`` keeps
    #: the as-traced execution order for staging / retracing).
    packed_profile: Optional[MemoryProfile] = None

    @property
    def plan_profile(self) -> MemoryProfile:
        return self.packed_profile if self.packed_profile is not None else self.profile

    @property
    def evicted_bids(self) -> set[int]:
        return {e.bid for e in self.evictions}

    @property
    def reached_target(self) -> bool:
        return self.target_peak is None or self.peak <= self.target_peak

    def by_mode(self) -> dict[str, int]:
        out = {"recompute": 0, "offload": 0}
        for e in self.evictions:
            out[e.mode] += 1
        return out

    def summary(self) -> dict:
        return {
            "n_evicted": len(self.evictions),
            "baseline_peak": self.baseline_peak,
            "peak": self.peak,
            "saving": 1.0 - self.peak / self.baseline_peak
            if self.baseline_peak else 0.0,
            "overhead_s": self.overhead_s,
            "modes": self.by_mode(),
            "reached_target": self.reached_target,
        }


def plan_evictions(profile: MemoryProfile,
                   costs: Optional[CostModel] = None, *,
                   target_peak: Optional[int] = None,
                   target_ratio: Optional[float] = None,
                   max_evict: int = 256,
                   max_candidates: int = 512,
                   min_bytes: int = 1,
                   candidate_filter=None,
                   price_mode: str = "auto",
                   solver: Callable[[MemoryProfile], AllocationPlan] = best_fit,
                   view=None,
                   reorder: str | bool | None = None,
                   groups=None,
                   ) -> EvictionPlan:
    """Select evictions until the packed peak meets the target (or stalls).

    ``candidate_filter(BlockCost) -> bool`` restricts the search to blocks a
    given mechanism can actually evict (e.g. only primitives an existing
    RematPolicy recomputes).

    ``groups`` — iterable of pattern groups (``remat.policy.pattern_group``):
    only blocks in those groups are eviction candidates.  The port traces
    no scan, so a group is a block's tag, the aten op that produced it.
    Composes with ``candidate_filter``.

    ``reorder`` — truthy runs the slack-reordering pass on every trial
    repack and scores the trial at ``min(identity, reordered)`` peak, so an
    eviction is bought only if it still pays after compaction.  The returned
    plan/profile are the winning variant; ``meta["reordered"]`` records
    whether the reordered schedule won (execution must adopt the order for
    the peak to be real — see ``core.reorder``).

    ``price_mode`` — "auto" prices each candidate at its cheaper mechanism
    (recompute vs offload); "recompute" prices and labels everything as
    recompute, for callers whose delivery mechanism is a ``torch.utils.checkpoint``
    policy (which folds offload selections into the recompute set).

    ``view`` — a ``core.unified.TenantView``: the search plans against the
    training tenant's share of a SharedArena instead of owning its own
    budget.  Without an explicit target, the target peak is the tenant's
    joint-plan budget, and the post-eviction profile is staged back so the
    arena rebalances the split at its next round boundary.
    """
    if price_mode not in ("auto", "recompute"):
        raise ValueError(f"unknown price_mode {price_mode!r}")
    if view is not None and target_peak is None and target_ratio is None:
        target_peak = view.budget
    costs = costs or CostModel.from_profile(profile)

    def repack(block_map):
        """Pack one trial; with ``reorder`` keep the cheaper of identity /
        slack-reordered schedules.  Returns (plan, packed_profile, reordered)."""
        prof = MemoryProfile(blocks=list(block_map.values()),
                             retained_bytes=profile.retained_bytes,
                             clock_end=profile.clock_end, meta=profile.meta)
        plan = solver(prof)
        if reorder:
            from ..core.reorder import reorder_profile
            res = reorder_profile(prof,
                                  mode="ils" if reorder is True else reorder,
                                  solver=solver)
            if res.plan.peak < plan.peak:
                return res.plan, res.profile, True
        return plan, prof, False

    blocks = {b.bid: b for b in profile.blocks}
    block_steps = profile.meta.get("block_steps", {})
    next_bid = max(blocks, default=0) + 1
    base_plan, base_packed, base_reordered = repack(blocks)
    baseline_peak = base_plan.peak
    if target_peak is None and target_ratio is not None:
        target_peak = int(baseline_peak * target_ratio)

    cur_plan, cur_packed, cur_reordered = base_plan, base_packed, base_reordered
    cur_peak = baseline_peak
    evictions: list[Eviction] = []
    n_tried = 0

    if price_mode == "recompute":
        cand_cost = lambda c: c.recompute_s
        cand_mode = lambda c: "recompute"
    else:
        cand_cost = lambda c: c.cost_s
        cand_mode = lambda c: c.mode

    pool = costs.candidates(min_bytes=min_bytes,
                            min_lifetime=_MIN_EVICT_LIFETIME)
    if groups is not None:
        from .policy import pattern_group
        group_set = frozenset(groups)
        pool = [c for c in pool if pattern_group(c.tag) in group_set]
    if candidate_filter is not None:
        pool = [c for c in pool if candidate_filter(c)]
    if price_mode != "auto":     # re-rank by area per *delivered* cost
        pool.sort(key=lambda c: c.hbm_area / max(cand_cost(c), 1e-12),
                  reverse=True)
    tr = get_tracer()
    if tr is not None:
        tr.instant("evict-search-start", "remat", track="search",
                   baseline_peak=baseline_peak, target_peak=target_peak,
                   n_candidates=len(pool))
    for cand in pool[:max_candidates]:
        if target_peak is not None and cur_peak <= target_peak:
            break
        if len(evictions) >= max_evict:
            break
        b = blocks.get(cand.bid)
        if b is None or b.lifetime < _MIN_EVICT_LIFETIME:
            continue
        steps = int(block_steps.get(b.bid, block_steps.get(str(b.bid), 1)))
        stubs = evict_block(b, next_bid, steps)
        if not stubs:
            continue
        n_tried += 1
        trial = dict(blocks)
        del trial[b.bid]
        for s in stubs:
            trial[s.bid] = s
        trial_plan, trial_packed, trial_reordered = repack(trial)
        if tr is not None:
            # one evict -> repack -> verify round, accepted or rolled back
            tr.instant("evict-trial", "remat", track="search", bid=b.bid,
                       tag=b.tag, trial_peak=trial_plan.peak,
                       cur_peak=cur_peak, accepted=trial_plan.peak < cur_peak)
        if trial_plan.peak >= cur_peak:      # replan says: no gain, roll back
            continue
        blocks = trial
        next_bid += 1
        cur_plan, cur_packed, cur_reordered = (trial_plan, trial_packed,
                                               trial_reordered)
        cur_peak = trial_plan.peak
        saved = b.size * b.lifetime - sum(s.size * s.lifetime for s in stubs)
        evictions.append(Eviction(bid=b.bid, mode=cand_mode(cand),
                                  saved_area=saved, cost_s=cand_cost(cand),
                                  tag=b.tag))

    final_profile = MemoryProfile(blocks=list(blocks.values()),
                                  retained_bytes=profile.retained_bytes,
                                  clock_end=profile.clock_end,
                                  meta=dict(profile.meta, evicted=len(evictions)))
    if tr is not None:
        tr.instant("evict-search-done", "remat", track="search",
                   n_evicted=len(evictions), n_tried=n_tried,
                   baseline_peak=baseline_peak, peak=cur_peak)
    if view is not None and evictions:
        # §4.3: rebalance at the boundary
        view.request_replan(final_profile, cause="evict-stage")
    return EvictionPlan(
        evictions=evictions,
        baseline_peak=baseline_peak,
        peak=cur_peak,
        overhead_s=sum(e.cost_s for e in evictions),
        target_peak=target_peak,
        plan=cur_plan,
        profile=final_profile,
        meta={"n_tried": n_tried, "solver": getattr(solver, "__name__", "?"),
              "reordered": cur_reordered,
              **({"groups": sorted(group_set)} if groups is not None else {})},
        packed_profile=cur_packed if cur_reordered else None,
    )
