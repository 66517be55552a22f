"""Profile-guided DSA memory planning (port of ``repro.core``: copies of its
framework-free modules, and a ``make_fx`` profile source in place of the
jaxpr one).

  - events: Block, MemoryProfile, make_profile
  - liveness: profile_fn / profile_graph (``make_fx`` fake-tensor trace ->
    MemoryProfile)
  - evict: the eviction stub transform the remat search and the MIP share
  - profiler: MemoryRecorder (runtime recorder with interrupt/resume)
  - bestfit: best_fit / incremental_fit / refit (§3 heuristic + §4.3
    warm-started replans), exact.solve_exact, mip.to_lp
  - reorder: slack-reordered lifetimes (precedence recovery + compaction
    in front of the packer)
  - solvers: scipy/HiGHS MILP backends (addresses-only, joint
    lifetime+address, eviction) behind the optional [solver] extra
  - arena.ArenaAllocator (O(1) planned allocation + §4.3 reoptimization)
  - pool: PoolAllocator / NaiveAllocator baselines
  - planner.MemoryPlanner (plan / plan_reordered / plan_fn / report /
    max_feasible_batch / plan_with_remat / plan_shared /
    max_feasible_batch_planned, H100 budgets)
  - unified.SharedArena (one HBM budget shared by serve + train tenants)
"""
from .arena import ArenaAllocator
from .bestfit import best_fit, incremental_fit, refit
from .dsa import AllocationPlan, PlanValidationError, plan_quality, validate_plan
from .events import Block, MemoryProfile, align, make_profile
from .exact import solve_exact
from .liveness import profile_fn, profile_graph
from .mip import exact_eviction_peak, to_lp, to_lp_eviction
from .planner import MemoryPlanner, PlanReport
from .pool import NaiveAllocator, PoolAllocator, replay
from .profiler import MemoryRecorder
from .reorder import PrecedenceGraph, ReorderResult, reorder_profile
from .solvers import (SolverUnavailable, have_solver, solve_eviction_milp,
                      solve_joint, solve_milp)
from .unified import SharedArena, SharedArenaError, SharedPlan, TenantView

__all__ = [
    "AllocationPlan", "ArenaAllocator", "Block", "MemoryPlanner", "MemoryProfile",
    "MemoryRecorder", "NaiveAllocator", "PlanReport", "PlanValidationError",
    "PoolAllocator", "PrecedenceGraph", "ReorderResult", "SharedArena",
    "SharedArenaError", "SharedPlan", "SolverUnavailable", "TenantView",
    "align", "best_fit", "exact_eviction_peak", "have_solver",
    "incremental_fit", "make_profile", "plan_quality", "profile_fn",
    "profile_graph", "refit", "reorder_profile", "replay", "solve_eviction_milp",
    "solve_exact", "solve_joint", "solve_milp", "to_lp", "to_lp_eviction",
    "validate_plan",
]
