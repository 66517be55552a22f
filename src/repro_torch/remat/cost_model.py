"""Per-block eviction cost model (the remat analogue of the paper's §3.1;
port of ``repro.remat.cost_model`` with the H100's constants).

In the planner's 2-D packing view every activation is a rectangle of
HBM *area* = bytes x lifetime.  Evicting it (recompute it in the backward
pass, or stage it to host) removes most of that area from the packing at a
time cost:

  * recompute  — FLOPs of the producing aten op / peak FLOPs.  The
    liveness profiler records per-block FLOPs in
    ``profile.meta["block_flops"]``.
  * offload    — 2 x bytes / host-link bandwidth (stage out + stage back).

The knapsack in ``search.py`` spends a time budget to buy packing area;
this module prices the candidates.

Recompute pricing defaults to the datasheet peak (``PEAK_FLOPS``), which
overstates achievable throughput — real steps hit a fraction of peak, so
datasheet pricing makes recompute look cheaper than it is.  When a measured
step time is available (``measured_step_s`` / ``calibrated_peak_flops``),
the model prices against *achieved* FLOPs/s = profiled step FLOPs / measured
seconds instead, falling back to the datasheet number when there is no
measurement or the profile carries no FLOP counts.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional

from ..core.events import Block, MemoryProfile
from ..core.planner import PEAK_FLOPS_BF16 as PEAK_FLOPS  # one hardware model

# bytes/s one way over the H100 SXM's host link, PCIe Gen5 x16 (NVIDIA H100
# data sheet: 128 GB/s for both directions together)
HOST_LINK_BW = 64e9

# Cheap-to-recompute elementwise ops get a flat FLOP floor so division by
# near-zero costs doesn't dominate the benefit ranking.
_MIN_FLOPS = 1.0


def calibrated_peak_flops(profile: MemoryProfile,
                          measured_step_s: Optional[float],
                          fallback: float = PEAK_FLOPS) -> float:
    """Effective FLOPs/s from a measured step time.

    achieved = (sum of profiled per-block FLOPs) / measured seconds.  This is
    a lower bound on the step's true FLOP count (only materialized blocks are
    charged), so the returned rate is conservative — recompute looks at most
    as cheap as it really is.  Falls back to ``fallback`` when there is no
    measurement, no FLOP metadata, or the measurement is nonsensical.
    """
    if not measured_step_s or measured_step_s <= 0:
        return fallback
    block_flops = profile.meta.get("block_flops", {})
    total = sum(float(f) for f in block_flops.values())
    if total <= 0:
        return fallback
    achieved = total / measured_step_s
    # A "measurement" above datasheet peak means the profile's FLOP count and
    # the timed region don't describe the same computation — distrust it.
    return min(achieved, fallback) if achieved > 0 else fallback


def measured_step_from_bench(bench, arch: Optional[str] = None,
                             mode: str = "none") -> Optional[float]:
    """Pull a step time the port measured on the card out of a result of
    the shape ``{"device": {"platform": "gpu", ...}, "configs": [{"arch",
    "step_time_s": {mode: seconds}}]}``.

    ``bench`` is the parsed dict or a path to the JSON file.  Returns the
    ``step_time_s[mode]`` of the config matching ``arch`` (first config when
    ``arch`` is None), or None when absent or when the result names no GPU
    (the reference's ``BENCH_remat.json`` holds TPU/CPU times, which say
    nothing of the card) — callers fall back to datasheet pricing.
    """
    if isinstance(bench, (str, bytes)):
        try:
            with open(bench) as f:
                bench = json.load(f)
        except (OSError, ValueError):
            return None
    if not isinstance(bench, dict):
        return None
    if (bench.get("device") or {}).get("platform") != "gpu":
        return None
    for cfg in bench.get("configs", []):
        if arch is not None and cfg.get("arch") != arch:
            continue
        step = (cfg.get("step_time_s") or {}).get(mode)
        if step and step > 0:
            return float(step)
    return None


@dataclass(frozen=True)
class BlockCost:
    """Eviction economics of one profiled block."""

    bid: int
    size: int                # bytes
    lifetime: int            # event-clock ticks
    hbm_area: int            # size x lifetime — what eviction buys back
    recompute_flops: float
    recompute_s: float
    offload_s: float
    tag: str

    @property
    def mode(self) -> str:
        """Cheaper of the two eviction mechanisms for this block."""
        return "recompute" if self.recompute_s <= self.offload_s else "offload"

    @property
    def cost_s(self) -> float:
        return min(self.recompute_s, self.offload_s)

    @property
    def benefit(self) -> float:
        """Packing area bought per second of overhead (knapsack key)."""
        return self.hbm_area / max(self.cost_s, 1e-12)


class CostModel:
    """Prices every block of a profile for the eviction search."""

    def __init__(self, costs: dict[int, BlockCost], *,
                 peak_flops: float = PEAK_FLOPS,
                 host_bw: float = HOST_LINK_BW,
                 calibrated: bool = False):
        self.costs = costs
        self.peak_flops = peak_flops
        self.host_bw = host_bw
        self.calibrated = calibrated     # priced from a measured step time?

    @classmethod
    def from_profile(cls, profile: MemoryProfile, *,
                     peak_flops: float = PEAK_FLOPS,
                     host_bw: float = HOST_LINK_BW,
                     measured_step_s: Optional[float] = None) -> "CostModel":
        """Price every block; ``measured_step_s`` (seconds for one step of
        the profiled computation on the card, e.g. via
        ``measured_step_from_bench``) calibrates recompute pricing to the
        achieved FLOP rate instead of the datasheet peak."""
        calibrated = False
        if measured_step_s is not None:
            eff = calibrated_peak_flops(profile, measured_step_s,
                                        fallback=peak_flops)
            calibrated = eff != peak_flops
            peak_flops = eff
        block_flops = profile.meta.get("block_flops", {})
        costs: dict[int, BlockCost] = {}
        for b in profile.blocks:
            if b.size == 0:
                continue
            # meta may have round-tripped through JSON (str keys)
            fl = block_flops.get(b.bid, block_flops.get(str(b.bid), 0.0))
            fl = max(float(fl), _MIN_FLOPS)
            costs[b.bid] = BlockCost(
                bid=b.bid, size=b.size, lifetime=b.lifetime,
                hbm_area=b.size * b.lifetime,
                recompute_flops=fl,
                recompute_s=fl / peak_flops,
                offload_s=2.0 * b.size / host_bw,
                tag=b.tag,
            )
        return cls(costs, peak_flops=peak_flops, host_bw=host_bw,
                   calibrated=calibrated)

    def __getitem__(self, bid: int) -> BlockCost:
        return self.costs[bid]

    def __contains__(self, bid: int) -> bool:
        return bid in self.costs

    def candidates(self, *, min_bytes: int = 0,
                   min_lifetime: int = 0) -> list[BlockCost]:
        """Blocks worth considering, best benefit-per-cost first."""
        out = [c for c in self.costs.values()
               if c.size >= min_bytes and c.lifetime >= min_lifetime]
        out.sort(key=lambda c: c.benefit, reverse=True)
        return out

    def total_overhead_s(self, bids) -> float:
        return sum(self.costs[b].cost_s for b in bids if b in self.costs)


def block_cost(b: Block, flops: float = 0.0, *,
               peak_flops: float = PEAK_FLOPS,
               host_bw: float = HOST_LINK_BW) -> BlockCost:
    """Price a single block directly (test/bench helper)."""
    fl = max(float(flops), _MIN_FLOPS)
    return BlockCost(bid=b.bid, size=b.size, lifetime=b.lifetime,
                     hbm_area=b.size * b.lifetime, recompute_flops=fl,
                     recompute_s=fl / peak_flops,
                     offload_s=2.0 * b.size / host_bw, tag=b.tag)
