"""SharedArena — one HBM budget, many workloads (serving × training).
Copy of ``repro.core.unified``.

The paper's claim is that ONE profile-guided allocator can own all of a
device's memory traffic.  Before this module the repo split that claim across
two planners: the paged KV pool (``serving/pages.py``) and the remat eviction
search (``remat/search.py``), each calling ``best_fit`` on a private arena —
so a box could serve OR fine-tune under an HBM budget, never both.

Here both workloads become *tenants* of a single arena:

  * the serving tenant submits its paged-staircase rectangles on the engine
    step clock;
  * the training tenant submits one profiled step's activation rectangles
    (its own event clock) plus how many fine-tune steps must land per
    serving round;
  * ``plan()`` schedules the training instances into the *valleys* of the
    serving load curve (the profile tells us where decode occupancy is low),
    maps everything onto one wall clock, and runs ONE best-fit pass over the
    union — the joint DSA peak sizes the split between the tenants;
  * when the joint peak misses the budget, the training tenant's ``shrink``
    hook (the remat eviction search) is asked to re-plan its step toward the
    headroom the serving tenant leaves — evict-vs-share is one trade;
  * §4.3 boundary replanning: ``request_replan()`` (decode outran its
    profile, or the training step's planned peak shifted) stages new
    rectangles, and ``reset_round()`` re-schedules + re-packs the union,
    rebalancing the split online without corrupting the other tenant's plan.

Everything is accounting-level, like the rest of the repo: physical safety
stays with the page free list / the caching allocator; the arena owns
sizes, offsets and admission budgets.
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Callable, Optional

from .bestfit import best_fit, refit
from .dsa import AllocationPlan, validate_plan
from .events import Block, MemoryProfile
from ..obs.trace import get_tracer

# Above this many joint rectangles each training instance is compressed to a
# single peak-sized envelope block (best-fit is ~quadratic).
MAX_JOINT_BLOCKS = 20_000


class SharedArenaError(RuntimeError):
    pass


@dataclass
class _Tenant:
    name: str
    kind: str                         # "serving" | "training"
    profile: MemoryProfile            # tenant-local clock
    steps_per_round: int = 1          # training: fine-tune steps per round
    shrink: Optional[Callable[[int], Optional[MemoryProfile]]] = None
    staged: Optional[MemoryProfile] = None   # §4.3: applied at reset_round()
    # standalone-packed-peak cache, invalidated when profile is replaced
    solo_peak: Optional[int] = None
    solo_profile: Optional[MemoryProfile] = None


class TenantView:
    """A tenant's handle onto the shared arena: its share of the split, and
    the §4.3 replan entry point.  Planners target ``budget`` instead of
    owning a private arena."""

    def __init__(self, arena: "SharedArena", name: str):
        self._arena = arena
        self.name = name

    @property
    def shared(self) -> "SharedArena":
        return self._arena

    @property
    def kind(self) -> str:
        return self._arena._tenants[self.name].kind

    @property
    def reserve(self) -> int:
        """Bytes this tenant is charged in the current joint plan."""
        return self._arena.plan().reserves[self.name]

    @property
    def standalone_peak(self) -> int:
        return self._arena.plan().standalone[self.name]

    @property
    def budget(self) -> int:
        """Bytes this tenant may peak at: the whole budget minus retained
        state and every *other* tenant's reserve.  Serving admission gates
        (``max_feasible_batch``) and the remat search target this."""
        p = self._arena.plan()
        others = sum(r for n, r in p.reserves.items() if n != self.name)
        return max(0, self._arena.hbm_budget - p.retained_bytes - others)

    def request_replan(self, profile: Optional[MemoryProfile] = None,
                       cause: str = "boundary-rebalance") -> None:
        """Flag observed drift (decode outran the profile / training peak
        shifted); optionally stage the newly observed rectangles.  Applied
        at the next ``reset_round()`` boundary — the paper's §4.3.
        ``cause`` feeds the per-cause replan counters the drift monitor
        reports."""
        self._arena.request_replan(self.name, profile, cause=cause)

    def stats(self) -> dict:
        p = self._arena.plan()
        return {"reserve": p.reserves[self.name], "budget": self.budget,
                "standalone_peak": p.standalone[self.name],
                "feasible": p.feasible}


@dataclass
class SharedPlan:
    """One joint planning pass: the packed union and the derived split."""

    joint_peak: int                    # DSA peak of the packed union
    plan: AllocationPlan               # offsets over the joint profile
    profile: MemoryProfile             # joint wall-clock profile
    standalone: dict                   # tenant -> standalone packed peak
    reserves: dict                     # tenant -> bytes charged (sum = joint)
    retained_bytes: int                # shared weights/optimizer state
    schedule: dict                     # training tenant -> instance phases
    feasible: bool                     # joint + retained fits the budget
    shrink_rounds: int = 0
    bid_map: dict = field(default_factory=dict)  # (tenant, bid) -> joint bid

    @property
    def standalone_sum(self) -> int:
        return sum(self.standalone.values())

    @property
    def sharing_win(self) -> int:
        """Bytes the joint plan saves vs giving each tenant its own arena."""
        return self.standalone_sum - self.joint_peak

    def summary(self) -> dict:
        return {
            "joint_peak": self.joint_peak,
            "standalone": dict(self.standalone),
            "standalone_sum": self.standalone_sum,
            "reserves": dict(self.reserves),
            "sharing_win": self.sharing_win,
            "joint_vs_sum": self.joint_peak / self.standalone_sum
            if self.standalone_sum else 1.0,
            "retained_bytes": self.retained_bytes,
            "schedule": {k: list(v) for k, v in self.schedule.items()},
            "feasible": self.feasible,
            "shrink_rounds": self.shrink_rounds,
        }


class SharedArena:
    """One HBM budget partitioned between tenants by a joint best-fit pass."""

    def __init__(self, hbm_budget: int, solver=best_fit, *,
                 max_shrink_rounds: int = 4,
                 reorder: str | bool | None = None,
                 incremental: bool = True):
        """``reorder`` ("greedy"/"ils"/True) runs the slack-reordering pass
        over the joint union before packing — advisory when serving tenants
        replay their original event order, so it defaults to off.
        ``incremental=True`` warm-starts each union re-pack from the previous
        one: rectangles stable across the rebalance (matched through the
        stable ``(tenant, local bid)`` key) keep their joint offsets, so §4.3
        boundary rebalances and shrink rounds stop paying full-repack cost.
        """
        self.hbm_budget = int(hbm_budget)
        self.solver = solver
        self.max_shrink_rounds = max_shrink_rounds
        self.reorder = reorder
        self.incremental = incremental
        self._tenants: dict[str, _Tenant] = {}
        self._plan: Optional[SharedPlan] = None
        self._last_union: Optional[tuple] = None   # (profile, plan, bid_map)
        self._dirty = False
        self.n_reopt = 0
        self.n_incr_packs = 0
        self.n_full_packs = 0
        self.last_pack_s = 0.0
        self.replan_causes: dict[str, int] = {}

    def _record_cause(self, cause: str, **trace_args) -> None:
        self.replan_causes[cause] = self.replan_causes.get(cause, 0) + 1
        t = get_tracer()
        if t is not None:
            t.instant("replan-request", "unified", track="arena",
                      cause=cause, **trace_args)

    # -- registration ----------------------------------------------------------
    def _register(self, t: _Tenant) -> TenantView:
        if t.name in self._tenants:
            raise SharedArenaError(f"tenant {t.name!r} already registered")
        self._tenants[t.name] = t
        self._plan = None
        tr = get_tracer()
        if tr is not None:
            tr.instant("tenant-register", "unified", track=t.name,
                       kind=t.kind, n_blocks=t.profile.n,
                       steps_per_round=t.steps_per_round)
        return TenantView(self, t.name)

    def register_serving(self, profile: MemoryProfile,
                         name: str = "serving") -> TenantView:
        """Serving tenant: paged-staircase rectangles on the engine-step
        clock (``serving.pages.paged_request_blocks``)."""
        return self._register(_Tenant(name=name, kind="serving",
                                      profile=profile))

    def register_training(self, step_profile: MemoryProfile,
                          steps_per_round: int = 1,
                          shrink: Optional[Callable] = None,
                          name: str = "training") -> TenantView:
        """Training tenant: ONE profiled step's activation rectangles on its
        own event clock, tiled ``steps_per_round`` times into the serving
        window.  ``shrink(target_peak) -> MemoryProfile | None`` lets the
        arena ask the remat eviction search to re-plan the step toward the
        headroom serving leaves (``None`` / unchanged peak = cannot shrink
        further)."""
        if steps_per_round < 1:
            raise ValueError(f"steps_per_round must be >= 1, got {steps_per_round}")
        return self._register(_Tenant(name=name, kind="training",
                                      profile=step_profile,
                                      steps_per_round=steps_per_round,
                                      shrink=shrink))

    # -- §4.3 boundary replanning ----------------------------------------------
    def request_replan(self, name: str,
                       profile: Optional[MemoryProfile] = None,
                       cause: str = "boundary-rebalance") -> None:
        t = self._tenants[name]
        if profile is not None:
            t.staged = profile
        self._record_cause(cause, tenant=name, staged=profile is not None)
        self._dirty = True

    def reset_round(self) -> bool:
        """Round boundary: apply staged rectangles and re-plan the union.
        Returns True if a replan happened."""
        if not self._dirty:
            return False
        old_peak = self._plan.joint_peak if self._plan is not None else 0
        for t in self._tenants.values():
            if t.staged is not None:
                t.profile = t.staged
                t.staged = None
        self._dirty = False
        self._plan = None
        self.plan()
        self.n_reopt += 1
        tr = get_tracer()
        if tr is not None:
            tr.instant("boundary-rebalance", "unified", track="arena",
                       n_reopt=self.n_reopt, old_joint_peak=old_peak,
                       new_joint_peak=self._plan.joint_peak,
                       reserves=dict(self._plan.reserves))
        return True

    # -- joint planning ----------------------------------------------------------
    def _serving_tenants(self) -> list[_Tenant]:
        return [t for t in self._tenants.values() if t.kind == "serving"]

    def _training_tenants(self) -> list[_Tenant]:
        return [t for t in self._tenants.values() if t.kind == "training"]

    def _solo(self, t: _Tenant) -> int:
        """Standalone packed peak of a tenant's current profile (cached —
        best-fit is ~quadratic and the profile only changes on replace)."""
        if t.solo_profile is not t.profile:
            t.solo_peak = self.solver(t.profile).peak
            t.solo_profile = t.profile
        return t.solo_peak

    def _window_steps(self) -> int:
        """Round window in engine steps (>= 1): the serving horizon when a
        serving tenant exists (training instances must fit inside it), else
        just enough slots for the training instances."""
        serving = self._serving_tenants()
        if serving:
            end = max((max((b.end for b in t.profile.blocks), default=0)
                       for t in serving), default=0)
            return max(1, end)
        return max([1] + [t.steps_per_round
                          for t in self._training_tenants()])

    def _load_curve(self, window: int) -> list[int]:
        """Serving live bytes per engine step — where the valleys are."""
        load = [0] * window
        for t in self._serving_tenants():
            for b in t.profile.blocks:
                for s in range(max(0, b.start), min(window, b.end)):
                    load[s] += b.size
        return load

    def _schedule_instances(self, t: _Tenant, window: int,
                            load: list[int]) -> list[int]:
        """Phases (engine steps) for the tenant's training instances: the
        ``steps_per_round`` lowest-load steps, earliest first on ties."""
        if t.steps_per_round > window:
            raise SharedArenaError(
                f"{t.name}: {t.steps_per_round} training steps do not fit a "
                f"{window}-step serving round")
        order = sorted(range(window), key=lambda s: (load[s], s))
        return sorted(order[:t.steps_per_round])

    def plan(self) -> SharedPlan:
        """Schedule + pack the union; cache until registration/replan."""
        if self._plan is not None:
            return self._plan
        if not self._tenants:
            raise SharedArenaError("no tenants registered")

        retained = max((t.profile.retained_bytes
                        for t in self._tenants.values()), default=0)
        packing_budget = self.hbm_budget - retained
        serving_solo = sum(self._solo(t) for t in self._serving_tenants())

        shrink_rounds = 0
        target: Optional[int] = None
        tr = get_tracer()
        while True:
            plan_obj = self._pack_union()
            overshoot = plan_obj.joint_peak - packing_budget
            if overshoot <= 0:
                break
            # over budget: ask a training tenant to shrink toward the
            # headroom serving leaves (serving is latency-critical and
            # keeps its demand).  The first round targets that headroom;
            # later rounds tighten by the remaining overshoot so a repeat
            # call to the same shrink hook has a strictly smaller target.
            target = (packing_budget - serving_solo if target is None
                      else target - overshoot)
            if target <= 0 or shrink_rounds >= self.max_shrink_rounds:
                break
            self._record_cause("over-budget", joint_peak=plan_obj.joint_peak,
                               budget=packing_budget)
            shrunk = False
            for t in self._training_tenants():
                if t.shrink is None:
                    continue
                new = t.shrink(target)
                if new is not None and \
                        self.solver(new).peak < self._solo(t):
                    t.profile = new
                    shrunk = True
            if not shrunk:
                break
            # a shrink replaces the training rectangles wholesale; warm-
            # starting the next union pack from the over-budget layout would
            # pin survivors at their old offsets (refit's quality bar is
            # relative to the previous peak — the very peak being shrunk
            # away), so force the post-shrink pack to start cold
            self._last_union = None
            shrink_rounds += 1
            if tr is not None:
                tr.instant("shrink-round", "unified", track="arena",
                           round=shrink_rounds, target=target,
                           joint_peak=plan_obj.joint_peak,
                           overshoot=overshoot)
        plan_obj.retained_bytes = retained
        plan_obj.feasible = plan_obj.joint_peak <= packing_budget
        plan_obj.shrink_rounds = shrink_rounds
        self._plan = plan_obj
        if tr is not None:
            tr.instant("joint-plan", "unified", track="arena",
                       joint_peak=plan_obj.joint_peak,
                       feasible=plan_obj.feasible,
                       shrink_rounds=shrink_rounds,
                       standalone_sum=plan_obj.standalone_sum)
        return plan_obj

    def _pack_union(self) -> SharedPlan:
        window = self._window_steps()
        load = self._load_curve(window)
        # joint clock resolution: one engine step spans the longest training
        # step's event clock, so a training instance nests inside one step
        span = max([1] + [max(1, t.profile.clock_end or
                              max((b.end for b in t.profile.blocks), default=1))
                          for t in self._training_tenants()])

        joint_blocks: list[Block] = []
        bid_map: dict = {}
        standalone: dict[str, int] = {}
        schedule: dict[str, list[int]] = {}
        next_bid = 0

        def add(tenant: str, local_bid, size, start, end, tag) -> None:
            nonlocal next_bid
            joint_blocks.append(Block(bid=next_bid, size=size, start=start,
                                      end=end, tag=tag))
            bid_map[(tenant, local_bid)] = next_bid
            next_bid += 1

        for t in self._serving_tenants():
            standalone[t.name] = self._solo(t)
            for b in t.profile.blocks:
                add(t.name, b.bid, b.size, b.start * span, b.end * span,
                    f"{t.name}/{b.tag or b.bid}")

        n_train_blocks = sum(
            len([b for b in t.profile.blocks if b.size > 0]) * t.steps_per_round
            for t in self._training_tenants())
        envelope = (len(joint_blocks) + n_train_blocks) > MAX_JOINT_BLOCKS

        tr = get_tracer()
        for t in self._training_tenants():
            standalone[t.name] = self._solo(t)
            phases = self._schedule_instances(t, window, load)
            schedule[t.name] = phases
            if tr is not None:
                tr.instant("valley-schedule", "unified", track=t.name,
                           phases=list(phases), window=window,
                           load_at_phases=[load[p] for p in phases])
            step_end = max(1, t.profile.clock_end or
                           max((b.end for b in t.profile.blocks), default=1))
            for k, phase in enumerate(phases):
                base = phase * span
                if envelope:
                    add(t.name, ("env", k), standalone[t.name], base,
                        base + step_end, f"{t.name}/step{k}")
                    continue
                for b in t.profile.blocks:
                    if b.size == 0:
                        continue
                    add(t.name, (k, b.bid), b.size, base + b.start,
                        base + b.end, f"{t.name}/step{k}/{b.tag or b.bid}")

        profile = MemoryProfile(
            blocks=joint_blocks,
            clock_end=window * span,
            meta={"kind": "unified", "window_steps": window, "span": span,
                  "envelope": envelope})
        t_pack = _time.perf_counter()
        pack_mode = "full"
        if self.reorder:
            from .reorder import reorder_profile
            mode = self.reorder if isinstance(self.reorder, str) else "ils"
            rres = reorder_profile(profile, mode=mode, solver=self.solver)
            profile, plan = rres.profile, rres.plan
            pack_mode = "reorder"
            profile.meta["reorder_improvement"] = rres.stats["improvement"]
        elif self.incremental and self._last_union is not None:
            # Re-key the previous union to the new joint bid space through
            # the stable (tenant, local bid) identity, then warm-start.
            prev_profile, prev_plan, prev_bid_map = self._last_union
            prev_by_joint = {b.bid: b for b in prev_profile.blocks}
            rb, ro = [], {}
            for key, new_bid in bid_map.items():
                old_bid = prev_bid_map.get(key)
                ob = prev_by_joint.get(old_bid) if old_bid is not None else None
                if ob is None or old_bid not in prev_plan.offsets:
                    continue
                rb.append(Block(bid=new_bid, size=ob.size, start=ob.start,
                                end=ob.end, tag=ob.tag))
                ro[new_bid] = prev_plan.offsets[old_bid]
            plan = refit(profile, MemoryProfile(blocks=rb),
                         AllocationPlan(offsets=ro, peak=prev_plan.peak,
                                        solver=prev_plan.solver),
                         solver=self.solver)
            pack_mode = plan.stats.get("mode", "full")
        else:
            plan = self.solver(profile)
        validate_plan(profile, plan)
        self.last_pack_s = _time.perf_counter() - t_pack
        if pack_mode == "incremental":
            self.n_incr_packs += 1
        else:
            self.n_full_packs += 1
        self._last_union = (profile, plan, dict(bid_map))
        tr2 = get_tracer()
        if tr2 is not None:
            tr2.instant("pack-union", "unified", track="arena",
                        mode=pack_mode, seconds=self.last_pack_s,
                        joint_peak=plan.peak, n_blocks=profile.n)

        # the split: serving (latency-critical) is charged its standalone
        # packing demand; training is charged only what it adds ON TOP of
        # that in the joint plan — the sharing win lands on training's bill
        reserves: dict[str, int] = {}
        remaining = plan.peak
        serving_names = [t.name for t in self._serving_tenants()]
        for n in serving_names:
            reserves[n] = min(standalone[n], remaining)
            remaining -= reserves[n]
        train_names = [t.name for t in self._training_tenants()]
        for i, n in enumerate(train_names):
            if i == len(train_names) - 1:
                reserves[n] = remaining
            else:
                reserves[n] = min(standalone[n], remaining)
            remaining -= reserves[n]
        if not train_names and serving_names:
            # no training tenant: any heuristic slack stays with serving
            reserves[serving_names[-1]] += remaining

        return SharedPlan(joint_peak=plan.peak, plan=plan, profile=profile,
                          standalone=standalone, reserves=reserves,
                          retained_bytes=0, schedule=schedule,
                          feasible=True, bid_map=bid_map)

    def stats(self) -> dict:
        p = self.plan()
        return {"hbm_budget": self.hbm_budget, "n_tenants": len(self._tenants),
                "n_reopt": self.n_reopt,
                "n_incr_packs": self.n_incr_packs,
                "n_full_packs": self.n_full_packs,
                "last_pack_s": self.last_pack_s,
                "replan_causes": dict(self.replan_causes), **p.summary()}
