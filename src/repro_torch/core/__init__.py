"""Profile-guided DSA memory planning (copies of ``repro.core``'s
framework-free modules; the jaxpr profile source, reordering, exact/MILP
solvers, remat and the shared arena are not ported yet).

  - events: Block, MemoryProfile, make_profile
  - profiler: MemoryRecorder (runtime recorder with interrupt/resume)
  - bestfit: best_fit / incremental_fit / refit
  - arena.ArenaAllocator (O(1) planned allocation + §4.3 reoptimization)
  - pool: PoolAllocator / NaiveAllocator baselines
  - planner.MemoryPlanner (plan / report / max_feasible_batch, H100 budgets)
"""
from .arena import ArenaAllocator
from .bestfit import best_fit, incremental_fit, refit
from .dsa import AllocationPlan, PlanValidationError, plan_quality, validate_plan
from .events import Block, MemoryProfile, align, make_profile
from .planner import MemoryPlanner, PlanReport
from .pool import NaiveAllocator, PoolAllocator, replay
from .profiler import MemoryRecorder

__all__ = [
    "AllocationPlan", "ArenaAllocator", "Block", "MemoryPlanner",
    "MemoryProfile", "MemoryRecorder", "NaiveAllocator", "PlanReport",
    "PlanValidationError", "PoolAllocator", "align", "best_fit",
    "incremental_fit", "make_profile", "plan_quality", "refit", "replay",
    "validate_plan",
]
