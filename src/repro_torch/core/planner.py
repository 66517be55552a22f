"""MemoryPlanner — the paper's workflow as a framework service.

profile (recorded events or request traces) -> DSA solve (best-fit) ->
validated AllocationPlan, plus the planning services built on top of it:
shared-memory budget checks for the CUDA kernels, HBM feasibility / maximum
mini-batch search, and side-by-side comparison against the pool/naive
baselines.  Trimmed copy of ``repro.core.planner``: the jaxpr profile
source, reordering, exact/MILP solvers and remat planning are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Sequence

import numpy as np

from .bestfit import best_fit
from .dsa import AllocationPlan, plan_quality, validate_plan
from .events import MemoryProfile
from .pool import NaiveAllocator, PoolAllocator, replay

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
}


class MemoryPlanner:
    def __init__(self, solver: str = "bestfit"):
        if solver not in _SOLVERS:
            raise ValueError(f"unknown solver {solver!r}; have {sorted(_SOLVERS)}")
        self.solver_name = solver
        self.solver = _SOLVERS[solver]

    def plan(self, profile: MemoryProfile) -> AllocationPlan:
        """Solve one DSA instance and validate the placement."""
        plan = self.solver(profile)
        validate_plan(profile, plan)
        return plan

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
                           lo: int = 1, hi: int = 65536) -> int:
        """Largest batch whose planned per-device peak fits the HBM budget.

        ``bytes_at_batch(b)`` must be monotone in ``b`` (it typically wraps a
        profile-and-plan of the step at mini-batch ``b``).
        """
        if bytes_at_batch(lo) > hbm_budget:
            return 0
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if bytes_at_batch(mid) <= hbm_budget:
                lo = mid
            else:
                hi = mid - 1
        return lo
