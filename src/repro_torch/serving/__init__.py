"""repro_torch.serving — continuous-batching engine with a profile-guided
paged KV-cache (port of ``repro.serving``).

A sample trace of requests is profiled as staircase rectangles (one per
page), packed with best-fit DSA, and the planned peak sizes the page pool.
On top of it sit the continuous-batching scheduler and the batched decode
engine.  Decode runs over a contiguous per-slot cache (``attn_mode=
"gather"``) or straight off per-layer page pools through the paged-attention
CUDA kernel (``attn_mode="paged"``).

Public API:
  - pages:     PagePlan, PagedKVCache, choose_page_tokens, paged_request_blocks
  - scheduler: GenRequest, Scheduler, RequestState
  - engine:    ServeEngine
  - runner:    DecodeRunner, bucket_ladder
  - metrics:   ServeMetrics
  - loadgen:   LoadGen, LoadSpec, LoadTrace, TrafficClass, make_loadgen
               (seeded trace-replay traffic; a copy of the reference's)
"""
from .engine import ServeEngine
from .loadgen import LoadGen, LoadSpec, LoadTrace, TrafficClass, make_loadgen
from .metrics import ServeMetrics
from .pages import (PagePlan, PagedKVCache, PagePoolExhausted,
                    choose_page_tokens, paged_request_blocks, plan_pool)
from .runner import DecodeRunner, bucket_ladder
from .scheduler import GenRequest, RequestState, Scheduler

__all__ = [
    "DecodeRunner", "GenRequest", "LoadGen", "LoadSpec", "LoadTrace",
    "PagePlan", "PagePoolExhausted", "PagedKVCache", "RequestState",
    "Scheduler", "ServeEngine", "ServeMetrics", "TrafficClass",
    "bucket_ladder", "choose_page_tokens", "make_loadgen",
    "paged_request_blocks", "plan_pool",
]
