"""Profile-guided paged KV-cache (paper §3-§4 applied to a page pool).

Instead of one contiguous final-length slab per request (the old
``ServeEngine``), cache memory is carved into fixed-size pages.  A request is
then a *staircase* of rectangles on the DSA plane: its prompt pages become
live at admission, and one growth page becomes live every ``page_tokens``
generated tokens — all ending when the request finishes.  Best-fit packs the
staircases, and the resulting planned peak (not a static heuristic) sizes the
physical pool:

  sample trace -> paged_request_blocks() -> MemoryPlanner/best_fit -> peak
              -> n_pages = ceil(peak / page_bytes)

``choose_page_tokens`` picks the page size the same way: candidate page sizes
are scored by planned peak plus page-table overhead, and the cheapest wins.

At runtime the physical allocator is a trivially-sound page free list; the
planner's ``ArenaAllocator`` rides along as the accountant so that requests
outgrowing their profiled lengths overflow and trigger a §4.3 boundary
replan (``stats()["n_reopt"]``), exactly like the training-shaped streams.

Port of ``repro.serving.pages``, with the ``SharedArena`` tenant mode and the
advisory ``reorder`` pass.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence

from ..configs.base import ModelConfig
from ..core import (ArenaAllocator, Block, MemoryPlanner, MemoryProfile,
                    align, best_fit)
from ..core.events import DEFAULT_ALIGNMENT
from ..core.pool import NaiveAllocator, PoolAllocator, replay
from ..core.unified import SharedArena, TenantView
from ..runtime.serve_lib import Request, cache_bytes_per_token, state_bytes

PAGE_TOKEN_CANDIDATES = (8, 16, 32, 64, 128)
PAGE_TABLE_ENTRY_BYTES = 8      # host-side cost per page-table entry


class PagePoolExhausted(RuntimeError):
    """No free page — the scheduler must preempt (or the pool must grow)."""


def page_bytes_for(cfg: ModelConfig, page_tokens: int) -> int:
    """Device bytes one page holds.  O(1)-state archs (bpt == 0) use a single
    state-sized page per request, so they never grow during decode."""
    if page_tokens < 1:
        raise ValueError(f"page_tokens must be >= 1, got {page_tokens}")
    bpt = cache_bytes_per_token(cfg)
    if bpt == 0:
        return align(max(state_bytes(cfg), 1), DEFAULT_ALIGNMENT)
    return align(bpt * page_tokens, DEFAULT_ALIGNMENT)


def pages_for_tokens(cfg: ModelConfig, page_tokens: int, tokens: int) -> int:
    """Pages a request with ``tokens`` of context occupies (state included)."""
    pb = page_bytes_for(cfg, page_tokens)
    total = cache_bytes_per_token(cfg) * tokens + state_bytes(cfg)
    return max(1, math.ceil(total / pb))


def paged_request_blocks(requests: Sequence[Request], cfg: ModelConfig,
                         page_tokens: int) -> MemoryProfile:
    """Requests -> staircase DSA blocks, one per page.

    Page 0..N0-1 (prompt + state) live [arrival, finish); growth page k
    becomes live at the decode step where the context first spills into it.
    Block ids are assigned in (start, rid, page index) order so an exact
    replay of the trace matches the arena's lambda sequence.
    """
    bpt = cache_bytes_per_token(cfg)
    sbytes = state_bytes(cfg)
    pb = page_bytes_for(cfg, page_tokens)
    staged: list[tuple[int, int, int, int, int]] = []  # (start, rid, k, end)
    for r in requests:
        finish = r.arrival + max(1, r.gen_len)
        n_total = pages_for_tokens(cfg, page_tokens, r.prompt_len + r.gen_len)
        present0 = bpt * r.prompt_len + sbytes
        n0 = min(n_total, max(1, math.ceil(present0 / pb))) if present0 else 1
        for k in range(n_total):
            if k < n0 or bpt == 0:
                start = r.arrival
            else:
                # context first spills into page k at this many total tokens
                t_k = math.ceil((k * pb - sbytes) / bpt)
                start = r.arrival + max(0, t_k - r.prompt_len)
            start = min(start, finish - 1)
            staged.append((start, r.rid, k, finish, pb))
    staged.sort()
    blocks = [Block(bid=i, size=pb, start=s, end=e, tag=f"req{rid}/p{k}")
              for i, (s, rid, k, e, pb) in enumerate(staged)]
    clock_end = max((b.end for b in blocks), default=0)
    return MemoryProfile(blocks=blocks, clock_end=clock_end,
                         meta={"kind": "serving-paged", "arch": cfg.name,
                               "page_tokens": page_tokens})


def plan_pool(cfg: ModelConfig, sample_trace: Sequence[Request],
              page_tokens: int, solver=best_fit,
              reorder: str | bool | None = None) -> "PagePlan":
    """Plan the sample trace and size the pool to the DSA peak.

    ``reorder`` additionally runs the slack-reordering pass over the
    staircase profile and reports the reordered peak in the baselines.  The
    pool is still sized by the identity-order plan: requests arrive in real
    time, so a reordered schedule is *advisory* for serving (it bounds what a
    replay-controlled admission order could reach), not a capacity claim.
    """
    profile = paged_request_blocks(sample_trace, cfg, page_tokens)
    plan = solver(profile)
    pb = page_bytes_for(cfg, page_tokens)
    n_pages = max(1, math.ceil(plan.peak / pb))
    reorder_baselines = {}
    if reorder:
        from ..core.reorder import reorder_profile
        mode = reorder if isinstance(reorder, str) else "ils"
        rres = reorder_profile(profile, mode=mode, solver=solver)
        reorder_baselines = {"reordered_dsa_peak": rres.peak,
                             "reorder_improvement": rres.stats["improvement"]}
    slab = MemoryProfile(blocks=[
        Block(bid=r.rid, size=align(
            cache_bytes_per_token(cfg) * (r.prompt_len + r.gen_len)
            + state_bytes(cfg), DEFAULT_ALIGNMENT),
            start=r.arrival, end=r.arrival + max(1, r.gen_len))
        for r in sample_trace])
    pool = replay(slab, PoolAllocator())
    naive = replay(slab, NaiveAllocator())
    return PagePlan(page_tokens=page_tokens, page_bytes=pb, n_pages=n_pages,
                    planned_peak=plan.peak, profile=profile,
                    baselines={"slab_peak": naive["peak"],
                               "pool_peak": pool["peak"],
                               "slab_dsa_peak": solver(slab).peak,
                               "paged_dsa_peak": plan.peak,
                               "lower_bound": profile.liveness_lower_bound(),
                               **reorder_baselines})


@dataclass(frozen=True)
class PagePlan:
    """Profile-guided pool sizing for one (arch, trace, page size) choice."""

    page_tokens: int
    page_bytes: int
    n_pages: int                   # pool capacity = ceil(planned_peak / page)
    planned_peak: int              # DSA peak of the staircase profile
    profile: MemoryProfile
    baselines: dict = field(default_factory=dict)

    @property
    def pool_bytes(self) -> int:
        return self.n_pages * self.page_bytes

    def table_overhead(self) -> int:
        return self.profile.n * PAGE_TABLE_ENTRY_BYTES

    def cost(self) -> int:
        """Planned device peak + host page-table overhead (selection metric)."""
        return self.planned_peak + self.table_overhead()


def choose_page_tokens(cfg: ModelConfig, sample_trace: Sequence[Request],
                       candidates: Sequence[int] = PAGE_TOKEN_CANDIDATES,
                       solver=best_fit,
                       reorder: str | bool | None = None) -> PagePlan:
    """Profile-guided page-size selection: plan the trace at every candidate
    page size and keep the cheapest (peak + table overhead; ties -> larger
    pages, i.e. smaller tables)."""
    best: Optional[PagePlan] = None
    for pt in sorted(candidates, reverse=True):
        plan = plan_pool(cfg, sample_trace, pt, solver=solver, reorder=reorder)
        if best is None or plan.cost() < best.cost():
            best = plan
    assert best is not None
    return best


def concurrency_bytes(cfg: ModelConfig, sample_trace: Sequence[Request],
                      page_tokens: int, batch: int, solver=best_fit) -> int:
    """Planned paged peak for ``batch`` concurrent in-flight requests.

    Resamples the trace shapes into a staggered wave of ``batch`` requests —
    the profile-guided analogue of "bytes at mini-batch b", fed to
    ``MemoryPlanner.max_feasible_batch`` for HBM admission control.
    """
    if not sample_trace or batch <= 0:
        return 0
    shapes = list(sample_trace)
    mean_gen = max(1, sum(r.gen_len for r in shapes) // len(shapes))
    stagger = max(1, mean_gen // max(1, batch))
    wave = [Request(rid=i + 1, prompt_len=shapes[i % len(shapes)].prompt_len,
                    gen_len=max(mean_gen, shapes[i % len(shapes)].gen_len),
                    arrival=i * stagger)
            for i in range(batch)]
    profile = paged_request_blocks(wave, cfg, page_tokens)
    return solver(profile).peak


def max_concurrency(cfg: ModelConfig, sample_trace: Sequence[Request],
                    page_tokens: int, hbm_budget: int,
                    retained_bytes: int = 0, hi: int = 4096) -> int:
    """Largest concurrent-request count whose planned peak fits HBM."""
    planner = MemoryPlanner()
    return planner.max_feasible_batch(
        lambda b: retained_bytes + concurrency_bytes(cfg, sample_trace,
                                                     page_tokens, b),
        hbm_budget=hbm_budget, hi=hi)


class PagedKVCache:
    """Fixed-size-page KV-cache pool, sized by the planner, with §4.3 reopt.

    Physical safety comes from the page free list (two live requests can
    never share a page); the planner's ``ArenaAllocator`` is kept in
    lockstep as the *accountant*: every page grab is mirrored as an
    ``arena.alloc(page_bytes)``, so a trace that replays the profile runs
    O(1) with zero overflow, while requests that outgrow their profiled
    lengths spill into the arena's overflow region and trigger a boundary
    replan at the next ``reset_epoch()`` — the §4.3 loop, under serving
    churn.  The pool itself resizes to the replanned peak at the boundary.
    """

    def __init__(self, cfg: ModelConfig, sample_trace: Sequence[Request],
                 page_tokens: Optional[int] = None,
                 reserve_pages: int = 0, solver=best_fit,
                 shared: Optional[SharedArena] = None,
                 tenant_name: str = "serving",
                 reorder: str | bool | None = None,
                 incremental: bool = True):
        """With ``shared``, the pool stops owning its memory claim: its
        staircase profile is registered as the serving tenant of the
        ``SharedArena``, replans are forwarded as §4.3 requests, and pool
        growth at epoch boundaries is clamped to the tenant's share of the
        joint budget.  ``reorder`` reports the advisory reordered peak in the
        plan baselines; ``incremental`` warm-starts the accounting arena's
        §4.3 replans from the previous plan."""
        self.cfg = cfg
        self.solver = solver
        if page_tokens is None:
            self.plan = choose_page_tokens(cfg, sample_trace, solver=solver,
                                           reorder=reorder)
        else:
            self.plan = plan_pool(cfg, sample_trace, page_tokens,
                                  solver=solver, reorder=reorder)
        self.page_tokens = self.plan.page_tokens
        self.page_bytes = self.plan.page_bytes
        self.reserve_pages = reserve_pages
        self.n_pages = self.plan.n_pages + reserve_pages
        self.arena = ArenaAllocator(self.plan.profile, solver=solver,
                                    mode="immediate", incremental=incremental)
        self.tenant: Optional[TenantView] = None
        if shared is not None:
            self.tenant = shared.register_serving(self.plan.profile,
                                                  name=tenant_name)
        self._free: list[int] = list(range(self.n_pages - 1, -1, -1))
        self.tables: dict[int, list[int]] = {}     # rid -> page ids
        self._addrs: dict[int, list[int]] = {}     # rid -> arena addrs
        self._tokens: dict[int, int] = {}          # rid -> context tokens held
        self.n_grown = 0                           # pool resizes at boundaries
        # Execution page tables: token-granularity page ids addressing the
        # *physical* KV pool the paged kernel reads.  Accounting page ids
        # above cannot serve this role — ``page_bytes_for`` aligns the page
        # and ``pages_for_tokens`` folds in state bytes, so the accounting
        # page count of a request need not equal ceil(tokens / page_tokens).
        # Exec pages are granted in lockstep with the accounting lifecycle
        # (admit/append/release) with a one-token lookahead: the engine
        # decodes (writing KV at position T) *before* append_token commits
        # token T+1, so the page holding position T must already be granted.
        # The exec pool grows on demand and recycles LIFO; its high-water is
        # bounded by max_batch * (ceil(max_len / page_tokens) + 1), so it
        # never exhausts and preemption stays purely accounting-driven.
        self.exec_tables: dict[int, list[int]] = {}
        self._exec_free: list[int] = []
        self.exec_n_pages = 0

    # -- capacity ---------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    def occupancy(self) -> float:
        return self.used_pages / self.n_pages if self.n_pages else 0.0

    def pages_for(self, tokens: int) -> int:
        return pages_for_tokens(self.cfg, self.page_tokens, tokens)

    def can_admit(self, prompt_len: int) -> bool:
        """Admission gate: the request's prompt pages fit the pool *now*.
        (Growth is handled by preemption; final-length feasibility is the
        scheduler's HBM gate via ``max_concurrency``.)"""
        return self.pages_for(prompt_len) <= self.free_pages

    # -- request lifecycle ------------------------------------------------------
    def _grab_page(self, rid: int) -> None:
        if not self._free:
            raise PagePoolExhausted(f"rid={rid}: pool of {self.n_pages} pages full")
        self.tables[rid].append(self._free.pop())
        self._addrs[rid].append(self.arena.alloc(self.page_bytes))

    def _exec_secure(self, rid: int, tokens: int) -> None:
        """Grant exec pages covering ``tokens`` token slots (never raises —
        the exec pool extends on demand; exhaustion policy lives entirely on
        the accounting side so preemption dynamics are mode-independent)."""
        need = max(1, math.ceil(tokens / self.page_tokens))
        tbl = self.exec_tables[rid]
        while len(tbl) < need:
            if not self._exec_free:
                self._exec_free.append(self.exec_n_pages)
                self.exec_n_pages += 1
            tbl.append(self._exec_free.pop())

    def exec_table(self, rid: int) -> list[int]:
        """Physical page-index row for ``rid`` (token t lives at page
        ``exec_table(rid)[t // page_tokens]``, offset ``t % page_tokens``)."""
        return self.exec_tables[rid]

    def admit(self, rid: int, prompt_len: int) -> list[int]:
        """Allocate the prompt/state pages; returns the page table."""
        if rid in self.tables:
            raise ValueError(f"rid={rid} already admitted")
        need = self.pages_for(prompt_len)
        if need > self.free_pages:
            raise PagePoolExhausted(
                f"rid={rid}: needs {need} pages, {self.free_pages} free")
        self.tables[rid] = []
        self._addrs[rid] = []
        self._tokens[rid] = prompt_len
        for _ in range(need):
            self._grab_page(rid)
        self.exec_tables[rid] = []
        self._exec_secure(rid, prompt_len + 1)      # +1: first decode write
        return self.tables[rid]

    def append_token(self, rid: int) -> None:
        """Account one generated token; grabs a growth page on spill.
        Raises ``PagePoolExhausted`` when the pool is full — the scheduler
        preempts a victim and retries; the token count is only committed
        once the pages are secured, so a retry never double-counts."""
        new_tokens = self._tokens[rid] + 1
        need = self.pages_for(new_tokens)
        while len(self.tables[rid]) < need:
            self._grab_page(rid)
        self._tokens[rid] = new_tokens
        self._exec_secure(rid, new_tokens + 1)      # +1: next decode write

    def ensure_free(self, n: int) -> None:
        """Grow the pool until at least ``n`` pages are free (last-resort
        admission for a request larger than anything profiled)."""
        deficit = n - self.free_pages
        if deficit > 0:
            self._free.extend(range(self.n_pages, self.n_pages + deficit))
            self.n_pages += deficit
            self.n_grown += 1

    def release(self, rid: int) -> None:
        """Return all of a request's pages (finish or preemption)."""
        for pid in self.tables.pop(rid, []):
            if pid < self.n_pages:      # pages above a shrunk pool just retire
                self._free.append(pid)
        for addr in self._addrs.pop(rid, []):
            self.arena.free(addr)
        self._tokens.pop(rid, None)
        self._exec_free.extend(self.exec_tables.pop(rid, []))

    def request_replan(self, cause: str = "decode-outrun") -> None:
        """Flag observed pressure (e.g. a preemption): replan at the boundary.
        ``cause`` tags the §4.3 counters the drift monitor reads — the
        engine's page-pool-exhaustion path is "decode-outrun"."""
        self.arena.request_replan(cause)
        if self.tenant is not None:
            self.tenant.request_replan(cause=cause)

    def reset_epoch(self) -> None:
        """Boundary: §4.3 replan from the shadow-observed stream, then resize
        the physical pool to the new planned peak (never below live pages).
        In shared mode the observed staircase is pushed to the SharedArena,
        the joint split is rebalanced, and growth is clamped to the serving
        tenant's share of the joint budget."""
        replanned = self.arena.n_reopt
        self.arena.reset_iteration()
        if self.tenant is not None and self.arena.n_reopt > replanned:
            # decode outran the profile: hand the observed rectangles to the
            # joint planner and rebalance the split at this boundary
            self.tenant.request_replan(self.arena.profile)
            self.tenant.shared.reset_round()
        planned = max(1, math.ceil(self.arena.peak / self.page_bytes))
        held = [p for t in self.tables.values() for p in t]
        # never shrink below the highest live page id: a later growth would
        # re-issue a held id and alias two requests onto one page
        floor = max(held) + 1 if held else 0
        target = max(planned + self.reserve_pages, floor)
        if self.tenant is not None:
            budget_pages = self.tenant.budget // self.page_bytes
            target = max(min(target, budget_pages), floor, 1)
        if target != self.n_pages:
            if target > self.n_pages:
                self._free.extend(range(self.n_pages, target))
            else:
                self._free = [p for p in self._free if p < target]
            self.n_pages = target
            self.n_grown += 1

    def stats(self) -> dict:
        a = self.arena.stats()
        out = {
            "page_tokens": self.page_tokens,
            "page_bytes": self.page_bytes,
            "n_pages": self.n_pages,
            "used_pages": self.used_pages,
            "pool_bytes": self.n_pages * self.page_bytes,
            "occupancy": self.occupancy(),
            "n_pool_resize": self.n_grown,
            "exec_n_pages": self.exec_n_pages,
            "exec_live_pages": sum(len(t) for t in self.exec_tables.values()),
            "n_reopt": a["n_reopt"],
            "n_incr_replans": a["n_incr_replans"],
            "n_full_replans": a["n_full_replans"],
            "last_replan_s": a["last_replan_s"],
            "planned_peak": a["peak"],
            "max_peak": a["max_peak"],
            "overflow_peak": a["overflow_peak"],
            "n_replan_requests": a["n_replan_requests"],
            "replan_causes": a["replan_causes"],
        }
        if self.tenant is not None:
            out["tenant"] = self.tenant.stats()
        return out
