"""MemoryPlanner — the paper's workflow as a framework service.

profile (``make_fx`` liveness, recorded events or request traces) -> DSA
solve (best-fit / exact / MILP) -> validated AllocationPlan, plus the
planning services built on top of it: shared-memory budget checks for the
CUDA kernels, HBM feasibility / maximum mini-batch search (with or without
remat), eviction planning (``plan_with_remat``), slack reordering
(``plan_reordered``), one HBM budget shared by a serving and a training
tenant (``plan_shared``), and side-by-side comparison against the pool/naive
baselines.  Port of ``repro.core.planner`` with H100 budgets.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Sequence

import numpy as np

from .bestfit import best_fit
from .dsa import AllocationPlan, plan_quality, validate_plan
from .events import MemoryProfile
from .exact import solve_exact
from .liveness import profile_fn
from .pool import NaiveAllocator, PoolAllocator, replay
from .reorder import ReorderResult, reorder_profile
from .solvers import SolverUnavailable, have_solver, solve_milp

# NVIDIA H100 SXM5 budgets (nvidia-smi names the card "NVIDIA H100 80GB HBM3";
# NVIDIA H100 data sheet, dense rates at the 700 W limit).
SMEM_BYTES = 232_448                   # 227 KB of shared memory per block
HBM_BYTES = 80 * 1000 ** 3             # 80 GB per card
PEAK_FLOPS_BF16 = 989e12               # dense bf16 tensor-core FLOP/s
PEAK_FLOPS_F32 = 67e12                 # f32 on the CUDA cores
PEAK_FLOPS_TF32 = 494.7e12             # dense TF32 tensor-core FLOP/s
HBM_BW = 3.35e12                       # bytes/s


@dataclass
class PlanReport:
    profile: MemoryProfile
    plan: AllocationPlan
    quality: dict
    baselines: dict


_SOLVERS: dict[str, Callable[[MemoryProfile], AllocationPlan]] = {
    "bestfit": best_fit,
    "exact": solve_exact,
    "milp": solve_milp,        # needs the [solver] extra (scipy/HiGHS)
}


class MemoryPlanner:
    def __init__(self, solver: str = "bestfit"):
        if solver not in _SOLVERS:
            raise ValueError(f"unknown solver {solver!r}; have {sorted(_SOLVERS)}")
        if solver == "milp" and not have_solver():
            raise SolverUnavailable(
                "solver='milp' needs scipy; install the [solver] extra")
        self.solver_name = solver
        self.solver = _SOLVERS[solver]

    def plan(self, profile: MemoryProfile, *,
             reorder: str | bool | None = None) -> AllocationPlan:
        """Solve one DSA instance; ``reorder`` runs the slack-reordering pass
        first (``"greedy"`` / ``"ils"`` / ``True`` = ils).

        With reordering the returned placement is for the *reordered*
        schedule — use :meth:`plan_reordered` when the caller also needs the
        reordered lifetimes.
        """
        if reorder:
            return self.plan_reordered(profile, mode=reorder).plan
        plan = self.solver(profile)
        validate_plan(profile, plan)
        return plan

    def plan_reordered(self, profile: MemoryProfile, *,
                       mode: str | bool = "ils", rounds: int = 8,
                       seed: int = 0) -> ReorderResult:
        """Reorder lifetimes within recovered dependency slack, then pack.

        The identity order is always a candidate, so
        ``result.peak <= plan(profile).peak``; the result carries both the
        reordered profile and its validated plan.
        """
        if mode is True:
            mode = "ils"
        result = reorder_profile(profile, mode=mode, rounds=rounds, seed=seed,
                                 solver=self.solver)
        validate_plan(result.profile, result.plan)
        return result

    def plan_fn(self, fn: Callable, *args) -> PlanReport:
        """Profile a function via ``make_fx`` liveness, solve, compare."""
        return self.report(profile_fn(fn, *args))

    def report(self, profile: MemoryProfile) -> PlanReport:
        plan = self.plan(profile)
        pool = replay(profile, PoolAllocator())
        naive = replay(profile, NaiveAllocator())
        return PlanReport(
            profile=profile,
            plan=plan,
            quality=plan_quality(profile, plan),
            baselines={
                "pool_peak": pool["peak"], "pool_us_per_event": pool["per_event_us"],
                "naive_peak": naive["peak"],
                "saving_vs_pool": 1.0 - plan.peak / pool["peak"] if pool["peak"] else 0.0,
            },
        )

    # -- CUDA planning services ----------------------------------------------------
    @staticmethod
    def smem_footprint(block_shapes: Iterable[tuple[Sequence[int], np.dtype]]) -> int:
        """Bytes of shared memory one CUDA block's working set occupies."""
        total = 0
        for shape, dtype in block_shapes:
            n = int(np.prod(shape)) if len(tuple(shape)) else 1
            total += n * np.dtype(dtype).itemsize
        return total

    @classmethod
    def check_smem(cls, block_shapes, budget: int = SMEM_BYTES) -> dict:
        used = cls.smem_footprint(block_shapes)
        return {"bytes": used, "budget": budget, "fits": used <= budget,
                "utilization": used / budget}

    def max_feasible_batch(self, bytes_at_batch: Callable[[int], int],
                           hbm_budget: int = HBM_BYTES,
                           lo: int = 1, hi: int = 65536,
                           guess: int | None = None) -> int:
        """Largest batch whose planned per-device peak fits the HBM budget.

        ``bytes_at_batch(b)`` must be monotone in ``b`` (it typically wraps a
        profile-and-plan of the step at mini-batch ``b``).  With a ``guess``
        the search gallops away from it until the answer is bracketed, then
        bisects: a close guess costs a few calls, and the answer has been
        evaluated at b (fits) and b + 1 (does not) unless b is ``hi``.
        """
        if guess is not None:
            return self._gallop(bytes_at_batch, hbm_budget, lo, hi,
                                min(max(guess, lo), hi))
        if bytes_at_batch(lo) > hbm_budget:
            return 0
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if bytes_at_batch(mid) <= hbm_budget:
                lo = mid
            else:
                hi = mid - 1
        return lo

    @staticmethod
    def _gallop(fits_bytes: Callable[[int], int], budget: int, lo: int, hi: int,
                b: int) -> int:
        def fits(n: int) -> bool:
            return fits_bytes(n) <= budget
        if fits(b):                                # gallop up to a miss (or hi)
            good, step = b, 1
            while good < hi and fits(min(good + step, hi)):
                good, step = min(good + step, hi), 2 * step
            if good == hi:
                return hi
            bad = min(good + step, hi)
        else:                                      # gallop down to a fit (or lo)
            bad, step = b, 1
            while bad - step >= lo and not fits(bad - step):
                bad, step = bad - step, 2 * step
            good = bad - step
            if good < lo:
                if bad == lo or not fits(lo):
                    return 0
                good = lo
        while bad - good > 1:                      # good fits, bad misses
            mid = (good + bad) // 2
            if fits(mid):
                good = mid
            else:
                bad = mid
        return good

    # -- remat-aware planning (repro_torch.remat) ----------------------------------
    def plan_with_remat(self, profile: MemoryProfile, *,
                        target_peak: int | None = None,
                        target_ratio: float | None = None,
                        max_evict: int = 256,
                        candidate_filter=None,
                        price_mode: str = "auto",
                        view=None,
                        reorder: str | bool | None = None,
                        groups=None):
        """Evict activations (recompute/offload) until the packed peak meets
        the target; returns the ``repro_torch.remat.EvictionPlan``.

        ``target_peak`` is a packing-peak target (excludes
        ``profile.retained_bytes``); with neither target the search buys
        every peak reduction it can find.  ``view`` (a SharedArena tenant
        view) makes the search plan against the training tenant's share of
        the joint budget instead.  ``reorder`` makes every eviction trial
        repack with the slack-reordering pass; ``groups`` restricts
        candidates to the given pattern groups (``remat.policy.pattern_group``).
        """
        from ..remat import plan_evictions
        return plan_evictions(profile, target_peak=target_peak,
                              target_ratio=target_ratio, max_evict=max_evict,
                              candidate_filter=candidate_filter,
                              price_mode=price_mode, solver=self.solver,
                              view=view, reorder=reorder, groups=groups)

    # -- unified serve x train planning (core.unified) ----------------------------
    def plan_shared(self, *, hbm_budget: int,
                    serving_profile: MemoryProfile | None = None,
                    training_profile: MemoryProfile | None = None,
                    train_steps: int = 1,
                    shrink: str | None = "remat",
                    max_evict: int = 256,
                    reorder: str | bool | None = None,
                    incremental: bool = True):
        """Build a ``SharedArena`` over one HBM budget and jointly plan the
        registered tenants.  ``shrink="remat"`` wires the eviction search as
        the training tenant's shrink hook, so evict-vs-share is resolved in
        the same pass.  ``reorder``/``incremental`` thread through to the
        joint pass (see ``SharedArena``).  Returns the planned ``SharedArena``.
        """
        from .unified import SharedArena
        arena = SharedArena(hbm_budget, solver=self.solver, reorder=reorder,
                            incremental=incremental)
        if serving_profile is not None:
            arena.register_serving(serving_profile)
        if training_profile is not None:
            shrink_fn = None
            if shrink == "remat":
                def shrink_fn(target: int):
                    ev = self.plan_with_remat(training_profile,
                                              target_peak=target,
                                              max_evict=max_evict)
                    return ev.profile if ev.evictions else None
            arena.register_training(training_profile,
                                    steps_per_round=train_steps,
                                    shrink=shrink_fn)
        arena.plan()
        return arena

    def max_feasible_batch_planned(self,
                                   profile_at_batch: Callable[[int], MemoryProfile],
                                   hbm_budget: int = HBM_BYTES,
                                   lo: int = 1, hi: int = 65536, *,
                                   remat=None, guess: int | None = None) -> int:
        """Remat-aware ``max_feasible_batch`` over actual profiles.

        ``profile_at_batch(b)`` profiles the training step at mini-batch
        ``b``.  Without ``remat`` the planned peak must fit the budget as-is;
        with ``remat`` truthy, the eviction search is allowed to shrink each
        probe's packing toward the remaining budget first — the paper's
        "larger mini-batch" benefit with the planner in the loop.  A compiled
        ``RematPolicy`` (mode "policy") constrains the search to blocks its
        recompute/offload sets can actually evict; ``True`` / mode "full"
        searches unconstrained.  ``guess`` starts the search there, as in
        ``max_feasible_batch``: a close one profiles fewer batches.
        """
        use_remat = bool(remat) and getattr(remat, "mode", "x") != "none"
        cand_filter = None
        if use_remat:
            from ..remat.policy import _prim_of_tag
            if getattr(remat, "mode", None) == "policy":
                allowed = remat.recompute_prims | remat.offload_prims

                def cand_filter(c):
                    return _prim_of_tag(c.tag) in allowed
            else:
                # full remat: exclude blocks no checkpoint policy can address;
                # untagged profiles (synthetic / recorded traces) carry no
                # provenance and stay eligible.
                def cand_filter(c):
                    return c.tag == "" or _prim_of_tag(c.tag) is not None

        def bytes_at(b: int) -> int:
            prof = profile_at_batch(b)
            if use_remat:
                if prof.retained_bytes > hbm_budget:
                    return prof.retained_bytes   # infeasible whatever we evict
                target = hbm_budget - prof.retained_bytes
                peak = self.plan_with_remat(prof, target_peak=target,
                                            candidate_filter=cand_filter).peak
            else:
                peak = self.plan(prof).peak
            return peak + prof.retained_bytes

        return self.max_feasible_batch(bytes_at, hbm_budget, lo, hi, guess)
