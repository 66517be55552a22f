"""Plan-vs-actual drift monitoring (the measurement half of §4.3; a copy of
``repro.obs.drift``).

The paper's premise is that a profiled trace predicts the real run well
enough to plan against; its §4.3 replanning exists because reality drifts.
This module quantifies that drift: a :class:`DriftMonitor` is anchored on a
*planned* profile (+ its DSA plan) and fed *observed* profiles — the event
streams ``MemoryRecorder`` captures, or an ``ArenaAllocator`` whose shadow
recorder already re-derived them — and reports:

  * ``peak_ratio``   — observed peak / planned peak (the headline number:
    1.0 means the profile predicted the run exactly);
  * ``drift_ratio``  — mean |observed − planned| live bytes over the step
    clock, normalized by the planned peak (shape drift, not just peak);
  * ``fragmentation`` — planned peak vs the liveness lower bound (how much
    of the plan is packing slack rather than real demand);
  * ``headroom_bytes`` — budget minus observed peak, when a budget is known;
  * ``replan_causes`` — per-cause replan counters (decode-outrun vs
    over-budget vs boundary-rebalance vs oversize/novel blocks), merged
    from every observed source;
  * ``peak_ratio_by_cause`` — worst observed peak ratio among observations
    in which each replan cause had fired, so "which kind of drift actually
    blows the plan" is a first-class number.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..core.bestfit import best_fit
from ..core.events import MemoryProfile


def live_curve(profile: MemoryProfile, bins: int = 64) -> list[int]:
    """Live bytes sampled over the profile's clock, normalized to ``bins``
    buckets (max within each bucket), so curves from different clock domains
    (engine steps vs event ticks) are comparable."""
    end = max(profile.clock_end,
              max((b.end for b in profile.blocks), default=0), 1)
    curve = [0] * bins
    events: list[tuple[int, int]] = []
    for b in profile.blocks:
        if b.size == 0:
            continue
        events.append((b.start, b.size))
        events.append((b.end, -b.size))
    events.sort()
    cur = 0
    # sweep the event clock; record the max live level within each bucket
    for t, delta in events:
        bucket = min(bins - 1, (t * bins) // end)
        cur += delta
        curve[bucket] = max(curve[bucket], cur)
    # forward-fill event-free buckets with the live level at their start
    running = 0
    evi = 0
    for bkt in range(bins):
        t_start = (bkt * end) // bins
        while evi < len(events) and events[evi][0] <= t_start:
            running += events[evi][1]
            evi += 1
        curve[bkt] = max(curve[bkt], running)
    return curve


@dataclass
class Observation:
    """One observed run (or boundary) compared against the plan."""

    peak: int                           # observed peak bytes
    profile: Optional[MemoryProfile]    # observed rectangles (if available)
    label: str = ""
    causes: dict = field(default_factory=dict)


class DriftMonitor:
    """Anchored on a planned profile; fed observed runs; reports the gap."""

    def __init__(self, planned: MemoryProfile, plan=None, *,
                 budget: Optional[int] = None, solver=best_fit,
                 bins: int = 64):
        self.planned = planned
        self.plan = plan if plan is not None else solver(planned)
        self.budget = budget
        self.bins = bins
        self._planned_curve = live_curve(planned, bins)
        self.observations: list[Observation] = []

    # -- feeding ------------------------------------------------------------------
    def observe(self, observed: MemoryProfile, *, peak: Optional[int] = None,
                label: str = "", causes: Optional[dict] = None) -> None:
        """Record one observed profile (e.g. ``MemoryRecorder.finish()``).

        ``peak`` defaults to the observed liveness lower bound — the actual
        simultaneous demand; pass an address peak (e.g. an arena's
        ``max_peak``, which includes overflow above the planned region)
        when one is known."""
        if peak is None:
            peak = observed.liveness_lower_bound()
        self.observations.append(Observation(peak=peak, profile=observed,
                                             label=label,
                                             causes=dict(causes or {})))

    def observe_arena(self, arena, *, label: str = "arena") -> None:
        """Convenience: an ``ArenaAllocator`` after a run.  ``max_peak`` is
        the observed address peak (planned region + overflow high-water);
        the arena's current profile is the latest observed stream; replan
        causes come from its cause counters."""
        self.observe(arena.profile, peak=arena.max_peak, label=label,
                     causes=dict(getattr(arena, "replan_causes", {})))

    # -- reporting ----------------------------------------------------------------
    def peak_ratio_by_cause(self) -> dict[str, float]:
        """Worst observed-peak / planned-peak per replan cause.

        An observation counts toward a cause when that cause had fired (count
        > 0) by the time it was recorded; arena cause counters are cumulative,
        so this reads as "once decode-outrun replans started happening, how
        far above plan did the run get".
        """
        planned_peak = self.plan.peak
        if not planned_peak:
            return {}
        out: dict[str, float] = {}
        for o in self.observations:
            ratio = o.peak / planned_peak
            for cause, count in o.causes.items():
                if count:
                    out[cause] = max(out.get(cause, 0.0), ratio)
        return out

    def report(self) -> dict:
        planned_peak = self.plan.peak
        lb = self.planned.liveness_lower_bound()
        frag = 1.0 - (lb / planned_peak) if planned_peak else 0.0

        observed_peak = max((o.peak for o in self.observations),
                            default=planned_peak)
        causes: dict[str, int] = {}
        for o in self.observations:
            for k, v in o.causes.items():
                causes[k] = causes.get(k, 0) + v

        drift_mean = drift_max = 0.0
        latest = next((o.profile for o in reversed(self.observations)
                       if o.profile is not None and o.profile.n), None)
        if latest is not None and planned_peak:
            oc = live_curve(latest, self.bins)
            deltas = [abs(a - b) for a, b in zip(oc, self._planned_curve)]
            drift_mean = sum(deltas) / len(deltas) / planned_peak
            drift_max = max(deltas) / planned_peak

        out = {
            "planned_peak": planned_peak,
            "observed_peak": observed_peak,
            "peak_ratio": (observed_peak / planned_peak) if planned_peak
            else 1.0,
            "fragmentation": frag,
            "liveness_lower_bound": lb,
            "drift_ratio_mean": drift_mean,
            "drift_ratio_max": drift_max,
            "n_observations": len(self.observations),
            "replan_causes": causes,
            "n_replans": sum(causes.values()),
            "peak_ratio_by_cause": self.peak_ratio_by_cause(),
        }
        if self.budget is not None:
            out["budget"] = self.budget
            out["headroom_bytes"] = self.budget - observed_peak
        return out
