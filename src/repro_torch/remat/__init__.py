"""repro_torch.remat — profile-guided rematerialization & host-offload
planning (port of ``repro.remat``).

The same liveness profile the DSA planner packs (``core.liveness``, a
``make_fx`` trace of the grad step) is used to *decide per-tensor* whether to
keep or recompute an activation:

  - cost_model: per-block HBM area vs recompute-FLOPs / host-link time (H100)
  - search:     greedy area-per-cost knapsack with best-fit replanning
  - policy:     RematPolicy — compiles a selection into a selective
                ``torch.utils.checkpoint`` policy
  - offload:    host staging arena instrumented with MemoryRecorder

Typical flow (see also ``runtime.train_lib.plan_remat_policy``):

    prof = profile_fn(grad_step, params, batch)             # no remat
    ev   = plan_evictions(prof, target_ratio=0.5)           # pick evictions
    policy = RematPolicy.from_eviction(ev)                  # compile
    model.loss_fn(params, batch, remat=policy)              # apply
"""
from .cost_model import (HOST_LINK_BW, PEAK_FLOPS, BlockCost, CostModel,
                         block_cost, calibrated_peak_flops,
                         measured_step_from_bench)
from .offload import HostOffloadArena
from .policy import RematPolicy, pattern_group
from .search import Eviction, EvictionPlan, evict_block, plan_evictions

__all__ = [
    "BlockCost", "CostModel", "Eviction", "EvictionPlan", "HOST_LINK_BW",
    "HostOffloadArena", "PEAK_FLOPS", "RematPolicy", "block_cost",
    "calibrated_peak_flops", "evict_block", "measured_step_from_bench",
    "pattern_group", "plan_evictions",
]
