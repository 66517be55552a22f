"""Profile-guided DSA memory planning (port of ``repro.core``: copies of its
framework-free modules, and a ``make_fx`` profile source in place of the
jaxpr one; reordering, the exact/MILP solvers and the shared arena are not
ported yet).

  - events: Block, MemoryProfile, make_profile
  - liveness: profile_fn / profile_graph (``make_fx`` fake-tensor trace ->
    MemoryProfile)
  - evict: the eviction stub transform the remat search uses
  - profiler: MemoryRecorder (runtime recorder with interrupt/resume)
  - bestfit: best_fit / incremental_fit / refit
  - arena.ArenaAllocator (O(1) planned allocation + §4.3 reoptimization)
  - pool: PoolAllocator / NaiveAllocator baselines
  - planner.MemoryPlanner (plan / plan_fn / report / max_feasible_batch /
    plan_with_remat / max_feasible_batch_planned, H100 budgets)
"""
from .arena import ArenaAllocator
from .bestfit import best_fit, incremental_fit, refit
from .dsa import AllocationPlan, PlanValidationError, plan_quality, validate_plan
from .events import Block, MemoryProfile, align, make_profile
from .liveness import profile_fn, profile_graph
from .planner import MemoryPlanner, PlanReport
from .pool import NaiveAllocator, PoolAllocator, replay
from .profiler import MemoryRecorder

__all__ = [
    "AllocationPlan", "ArenaAllocator", "Block", "MemoryPlanner",
    "MemoryProfile", "MemoryRecorder", "NaiveAllocator", "PlanReport",
    "PlanValidationError", "PoolAllocator", "align", "best_fit",
    "incremental_fit", "make_profile", "plan_quality", "profile_fn",
    "profile_graph", "refit", "replay", "validate_plan",
]
