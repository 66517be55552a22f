"""Optimized arena allocator (paper §4.2) with reoptimization (§4.3).

After planning, every request in the hot region is answered in O(1): the
allocator simply returns ``p + x_lambda`` and advances ``lambda``.

§4.3 generalization, as implemented here:
  * request LARGER than profiled for a known block id -> immediate replan
    with the enlarged size (lifetimes are already known);
  * request for a NOVEL block id (a longer iteration than ever profiled) ->
    served from an overflow pool above the arena, while a shadow recorder
    captures the iteration's true event stream; at the next
    ``reset_iteration()`` the profile is re-derived from the observed stream
    (sizes take the elementwise max with the old profile) and the plan is
    recomputed — "reoptimize using the new observed parameters".  Replans
    therefore happen only when a new record length is seen, so their
    frequency decays as training proceeds (paper §5.3 observation);
  * requests inside ``interrupt()``/``resume()`` windows go to a fallback
    pool and are never packed.
"""
from __future__ import annotations

import time as _time
from contextlib import contextmanager
from typing import Callable

from .bestfit import best_fit, refit
from .dsa import AllocationPlan, validate_plan
from .events import DEFAULT_ALIGNMENT, Block, MemoryProfile, align
from .pool import PoolAllocator
from .profiler import MemoryRecorder
from ..obs.trace import get_tracer


class ArenaAllocator:
    """Serves planned offsets for the hot region of a propagation.

    The arena is an abstract [base, base + peak) byte range; callers map it
    onto a real backing store (device slab, pinned host buffer, numpy array).
    ``base`` is the paper's ``p``.
    """

    def __init__(self, profile: MemoryProfile, base: int = 0,
                 alignment: int = DEFAULT_ALIGNMENT,
                 solver: Callable[[MemoryProfile], AllocationPlan] = best_fit,
                 mode: str = "immediate", incremental: bool = True):
        """``mode``:
        * "immediate" — the paper's §4.3 literally: a larger-than-profiled
          request at a known id replans in place (right for stable streams
          whose block *sizes* grow, e.g. serving requests);
        * "signature" — beyond-paper: any mismatch overflows for the rest of
          the iteration and the boundary replan is CACHED per stream
          signature, so workloads cycling over a finite set of shapes
          (seq2seq length buckets) stop replanning once warm.

        ``incremental=True`` warm-starts every replan from the previous
        (profile, plan): blocks whose rectangles did not change keep their
        offsets and only the changed ones are re-placed (``bestfit.refit``,
        which falls back to a full repack when too much changed or the
        incremental peak degrades past tolerance).
        """
        assert mode in ("immediate", "signature"), mode
        self.mode = mode
        self.incremental = incremental
        self._solver = solver
        self.alignment = alignment
        self.base = base
        self.profile = profile
        self.plan = solver(profile)
        validate_plan(profile, self.plan)
        self._by_bid = {b.bid: b for b in profile.blocks}
        self._lam0 = min((b.bid for b in profile.blocks), default=1)
        self.lam = self._lam0
        self.n_reopt = 0
        self.n_plan_switch = 0
        self.n_fallback = 0
        self.reopt_seconds = 0.0
        self.n_incr_replans = 0
        self.n_full_replans = 0
        self.last_replan_s = 0.0
        self._interrupted = 0
        self._fallback = PoolAllocator(alignment=alignment)
        self._overflow = PoolAllocator(alignment=alignment)
        self._overflow_addrs: set[int] = set()
        self._dirty = False
        self._shadow = MemoryRecorder(alignment=alignment)
        self._addr_to_shadow: dict[int, int] = {}
        self._plan_cache: dict = {self._signature(profile): (profile, self.plan)}
        self._hint_to_sig: dict = {}
        self._hint = None
        self.max_peak = self.plan.peak
        # §4.3 accounting for the drift monitor: why each replan was asked
        self.n_replan_requests = 0
        self.replan_causes: dict[str, int] = {}

    def _record_cause(self, cause: str) -> None:
        self.n_replan_requests += 1
        self.replan_causes[cause] = self.replan_causes.get(cause, 0) + 1
        t = get_tracer()
        if t is not None:
            t.instant("replan-request", "arena", track="arena", cause=cause)

    @staticmethod
    def _signature(profile: MemoryProfile):
        return (profile.n, tuple(b.size for b in profile.blocks))

    # -- §4.2: the O(1) hot path -------------------------------------------------
    def alloc(self, size: int) -> int:
        """Return the absolute address for the next hot-region request."""
        t = get_tracer()
        if self._interrupted:
            self.n_fallback += 1
            if t is not None:
                t.instant("alloc-fallback", "arena", track="arena", size=size)
            return (self.base + self.plan.peak + (1 << 40) +
                    self._fallback.malloc(("nh", self.n_fallback), size))
        size = align(size, self.alignment)
        bid = self.lam
        self.lam += 1
        sid = self._shadow.on_alloc(size)
        blk = self._by_bid.get(bid)
        if blk is not None and size > blk.size and self.mode == "immediate":
            self._reoptimize(bid, size)     # lifetimes known: replan in place
            blk = self._by_bid[bid]
        if blk is None or size > blk.size:
            # novel/oversized block: overflow region now, replan at boundary
            if not self._dirty:
                self._record_cause("novel-block")
            self._dirty = True
            addr = (self.base + self.plan.peak +
                    self._overflow.malloc(("ov", sid), size))
            self._overflow_addrs.add(addr)
            self._addr_to_shadow[addr] = (sid, ("ov", sid))
            self.max_peak = max(self.max_peak,
                                self.plan.peak + self._overflow.peak)
            if t is not None:
                t.instant("alloc-overflow", "arena", track="arena", bid=bid,
                          size=size, addr=addr)
            return addr
        addr = self.base + self.plan.offsets[bid]
        self._addr_to_shadow[addr] = (sid, None)
        if t is not None:
            t.instant("alloc", "arena", track="arena", bid=bid, size=size,
                      addr=addr)
        return addr

    def free(self, addr: int) -> None:
        if self._interrupted:
            self.n_fallback += 1
            return
        entry = self._addr_to_shadow.pop(addr, None)
        if entry is None:
            return
        t = get_tracer()
        if t is not None:
            t.instant("free", "arena", track="arena", addr=addr)
        sid, ov_handle = entry
        self._shadow.on_free(sid)
        if ov_handle is not None:
            self._overflow.free(ov_handle)
            self._overflow_addrs.discard(addr)

    def reset_iteration(self, hint=None) -> None:
        """Paper §4.2: lambda re-initialized before each forward pass; §4.3:
        deferred replan from the shadow-observed stream when needed.

        ``hint`` (signature mode): an opaque caller key for the upcoming
        iteration's shape (e.g. the batch's sequence-length bucket).  If a
        plan was already cached under that hint, it is installed up front so
        the iteration runs with zero overflow."""
        if self._dirty:
            self._replan_from_shadow()
        if (hint is not None and self.mode == "signature"):
            sig = self._hint_to_sig.get(hint)
            cached = self._plan_cache.get(sig) if sig is not None else None
            if cached is not None and cached[1] is not self.plan:
                self.profile, self.plan = cached
                self._by_bid = {b.bid: b for b in self.profile.blocks}
                self._lam0 = min((b.bid for b in self.profile.blocks),
                                 default=1)
                self.n_plan_switch += 1
        self._hint = hint
        self.lam = self._lam0
        self._shadow = MemoryRecorder(alignment=self.alignment)
        self._addr_to_shadow.clear()
        self._overflow = PoolAllocator(alignment=self.alignment)
        self._overflow_addrs.clear()

    @property
    def peak(self) -> int:
        return self.plan.peak

    def request_replan(self, cause: str = "requested") -> None:
        """Force a §4.3 boundary replan from the shadow-observed stream at the
        next ``reset_iteration()`` (callers flag observed memory pressure the
        lambda stream itself cannot see, e.g. serving preemption).

        ``cause`` is a machine-readable tag ("decode-outrun", "over-budget",
        "boundary-rebalance", ...) counted in ``replan_causes`` and consumed
        by the drift monitor."""
        self._record_cause(cause)
        self._dirty = True

    # -- §4.3: interrupt/resume ----------------------------------------------------
    def interrupt(self) -> None:
        self._interrupted += 1
        t = get_tracer()
        if t is not None:
            t.instant("interrupt", "arena", track="arena",
                      depth=self._interrupted)

    def resume(self) -> None:
        if not self._interrupted:
            raise RuntimeError("resume() without interrupt()")
        self._interrupted -= 1
        t = get_tracer()
        if t is not None:
            t.instant("resume", "arena", track="arena",
                      depth=self._interrupted)

    @contextmanager
    def non_hot(self):
        self.interrupt()
        try:
            yield
        finally:
            self.resume()

    # -- §4.3: reoptimization --------------------------------------------------------
    def _reoptimize(self, bid: int, size: int) -> None:
        """Immediate replan for a known block observed at a larger size."""
        t0 = _time.perf_counter()
        self._record_cause("oversize-immediate")
        old = self._by_bid[bid]
        blocks = [b if b.bid != bid else
                  Block(bid=bid, size=size, start=old.start, end=old.end,
                        tag=old.tag)
                  for b in self.profile.blocks]
        self._install(MemoryProfile(blocks=blocks,
                                    retained_bytes=self.profile.retained_bytes,
                                    clock_end=self.profile.clock_end,
                                    meta=self.profile.meta),
                      cause="oversize-immediate")
        self.reopt_seconds += _time.perf_counter() - t0

    def _replan_from_shadow(self) -> None:
        """Boundary replan from the observed stream ("the new observed
        parameters", §4.3).  Streams of different lengths put the same
        logical tensor at different lambda positions, so the observed stream
        REPLACES the profile; in "signature" mode the (profile, plan) pair is
        cached per stream signature, so a workload cycling over a finite set
        of shapes stops replanning once every shape has been seen."""
        t0 = _time.perf_counter()
        observed = self._shadow.finish(meta=self.profile.meta)
        if observed.n:
            sig = self._signature(observed)
            if self._hint is not None:
                self._hint_to_sig[self._hint] = sig
            cached = self._plan_cache.get(sig) if self.mode == "signature" else None
            if cached is not None:
                self.profile, self.plan = cached
                self._by_bid = {b.bid: b for b in self.profile.blocks}
                self._lam0 = min((b.bid for b in self.profile.blocks), default=1)
                self.n_plan_switch += 1
            else:
                self._install(MemoryProfile(
                    blocks=observed.blocks,
                    retained_bytes=self.profile.retained_bytes,
                    clock_end=observed.clock_end,
                    meta=self.profile.meta))
                if self.mode == "signature":
                    self._plan_cache[sig] = (self.profile, self.plan)
        self._dirty = False
        self.max_peak = max(self.max_peak, self.plan.peak)
        self.reopt_seconds += _time.perf_counter() - t0

    def _install(self, profile: MemoryProfile, cause: str = "boundary") -> None:
        t0 = _time.perf_counter()
        old_peak = self.plan.peak
        if self.incremental:
            plan = refit(profile, self.profile, self.plan, solver=self._solver)
        else:
            plan = self._solver(profile)
            plan.stats.setdefault("mode", "full")
        validate_plan(profile, plan)
        self.profile = profile
        self.plan = plan
        replan_mode = plan.stats.get("mode", "full")
        if replan_mode == "incremental":
            self.n_incr_replans += 1
        else:
            self.n_full_replans += 1
        self._by_bid = {b.bid: b for b in profile.blocks}
        self._lam0 = min((b.bid for b in profile.blocks), default=1)
        self.n_reopt += 1
        self.max_peak = max(self.max_peak, self.plan.peak)
        self.last_replan_s = _time.perf_counter() - t0
        t = get_tracer()
        if t is not None:
            t.instant("replan", "arena", track="arena", n_reopt=self.n_reopt,
                      old_peak=old_peak, new_peak=self.plan.peak,
                      n_blocks=profile.n, cause=cause, mode=replan_mode,
                      seconds=self.last_replan_s)

    def stats(self) -> dict:
        return {
            "peak": self.plan.peak,
            "max_peak": self.max_peak,
            "n_blocks": self.profile.n,
            "n_reopt": self.n_reopt,
            "n_incr_replans": self.n_incr_replans,
            "n_full_replans": self.n_full_replans,
            "last_replan_s": self.last_replan_s,
            "n_plan_switch": self.n_plan_switch,
            "reopt_seconds": self.reopt_seconds,
            "n_fallback": self.n_fallback,
            "fallback_peak": self._fallback.peak,
            "overflow_peak": self._overflow.peak,
            "plans_cached": len(self._plan_cache),
            "n_replan_requests": self.n_replan_requests,
            "replan_causes": dict(self.replan_causes),
        }
