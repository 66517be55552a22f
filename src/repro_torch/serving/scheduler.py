"""Continuous-batching scheduler over the profile-guided page pool.

Every engine step the scheduler:
  1. admits from the waiting queue (FCFS or priority order) while a physical
     slot is free, the request's prompt pages fit the pool, and the planned
     concurrency stays under the HBM-feasible cap (``pages.max_concurrency``
     via ``MemoryPlanner.max_feasible_batch``);
  2. advances chunked prefill — each step spends at most
     ``prefill_chunk`` prompt tokens across admitted-but-not-yet-decoding
     requests, so a long prompt cannot monopolize a step;
  3. on page-pool exhaustion mid-decode, preempts the *youngest* running
     request (latest admission; ties by lowest priority): its pages and slot
     are released and it re-enters the queue head for recompute, while the
     outgrown profile is replanned at the next epoch boundary (§4.3).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Optional

from ..obs.trace import get_tracer
from .pages import PagedKVCache

POLICIES = ("fcfs", "priority")


@dataclass
class GenRequest:
    """One generation request as the engine sees it.

    ``gen_len`` is the *actual* number of tokens the request will generate;
    the planner only ever sees the sample trace, so a request may well
    outgrow its profiled length — that is the reoptimization path.
    """
    rid: int
    prompt: Any                  # (S,) int32 token array
    gen_len: int
    priority: int = 0            # higher = more urgent ("priority" policy)
    arrival: int = 0             # engine step at which the request appears


class RequestState(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"          # admitted; chunked prefill in progress
    RUNNING = "running"          # in the decode batch
    PREEMPTED = "preempted"      # evicted; waiting for re-admission
    DONE = "done"


@dataclass
class ScheduledRequest:
    req: GenRequest
    state: RequestState = RequestState.WAITING
    slot: int = -1
    admit_step: int = -1
    prefill_done: int = 0        # prompt tokens already processed (chunked)
    out: list = field(default_factory=list)
    n_preempt: int = 0

    @property
    def rid(self) -> int:
        return self.req.rid

    @property
    def prompt_len(self) -> int:
        return int(self.req.prompt.shape[0])

    @property
    def remaining(self) -> int:
        return self.req.gen_len - len(self.out)


class Scheduler:
    """Queue + admission control + preemption policy (no model calls)."""

    def __init__(self, kv: PagedKVCache, *, max_batch: int,
                 policy: str = "fcfs", max_concurrency: Optional[int] = None,
                 prefill_chunk: int = 512):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; have {POLICIES}")
        self.kv = kv
        self.policy = policy
        self.max_batch = max_batch
        self.cap = max_batch if max_concurrency is None else \
            max(1, min(max_batch, max_concurrency))
        self.prefill_chunk = max(1, prefill_chunk)
        self.waiting: list[ScheduledRequest] = []
        self.active: dict[int, ScheduledRequest] = {}   # rid -> PREFILL/RUNNING
        self._free_slots: list[int] = list(range(max_batch - 1, -1, -1))

    # -- queue -------------------------------------------------------------------
    def enqueue(self, req: GenRequest) -> ScheduledRequest:
        sr = ScheduledRequest(req=req)
        self.waiting.append(sr)
        return sr

    def _queue_order(self) -> list[ScheduledRequest]:
        if self.policy == "priority":
            # stable: highest priority first, FCFS within a priority class
            return sorted(self.waiting, key=lambda s: -s.req.priority)
        return list(self.waiting)

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    @property
    def n_active(self) -> int:
        return len(self.active)

    # -- admission ----------------------------------------------------------------
    def _do_admit(self, sr: ScheduledRequest, step: int) -> ScheduledRequest:
        self.waiting.remove(sr)
        sr.slot = self._free_slots.pop()
        sr.admit_step = step
        sr.state = RequestState.PREFILL
        # re-admission after preemption restarts from scratch (recompute)
        sr.prefill_done = 0
        sr.out = []
        self.kv.admit(sr.rid, sr.prompt_len)
        self.active[sr.rid] = sr
        t = get_tracer()
        if t is not None:
            t.instant("admit", "serving", track="scheduler", rid=sr.rid,
                      slot=sr.slot, prompt_len=sr.prompt_len,
                      n_active=self.n_active)
        return sr

    def admit(self, step: int) -> list[ScheduledRequest]:
        """Admit as many waiting requests as the gates allow this step."""
        admitted = []
        for sr in self._queue_order():
            if not self._free_slots or self.n_active >= self.cap:
                break
            if not self.kv.can_admit(sr.prompt_len):
                if self.policy == "fcfs":
                    break           # preserve FCFS: no overtake on memory
                continue            # priority: try the next class down
            admitted.append(self._do_admit(sr, step))
        if not admitted and not self.active and self.waiting and self._free_slots:
            # nothing can run: the head request is larger than anything the
            # profile planned for — grow the pool rather than deadlock
            sr = self._queue_order()[0]
            self.kv.ensure_free(self.kv.pages_for(sr.prompt_len))
            admitted.append(self._do_admit(sr, step))
        return admitted

    def prefill_batch(self) -> list[ScheduledRequest]:
        """Spend this step's prefill-token budget; returns the requests whose
        prefill *completed* this step (ready for their model prefill call)."""
        budget = self.prefill_chunk
        ready = []
        t = get_tracer()
        for sr in sorted(self.active.values(), key=lambda s: s.admit_step):
            if sr.state is not RequestState.PREFILL or budget <= 0:
                continue
            take = min(budget, sr.prompt_len - sr.prefill_done)
            sr.prefill_done += take
            budget -= take
            if t is not None:
                t.instant("prefill-chunk", "serving", track="scheduler",
                          rid=sr.rid, take=take, done=sr.prefill_done,
                          prompt_len=sr.prompt_len, budget_left=budget)
            if sr.prefill_done >= sr.prompt_len:
                sr.state = RequestState.RUNNING
                ready.append(sr)
        return ready

    def running(self) -> list[ScheduledRequest]:
        return [s for s in self.active.values()
                if s.state is RequestState.RUNNING and s.out]

    # -- preemption ----------------------------------------------------------------
    def preempt_victim(self) -> Optional[ScheduledRequest]:
        """Evict the youngest (latest-admitted; ties -> lowest priority)
        active request back to the queue head; frees its slot and pages."""
        if not self.active:
            return None
        victim = max(self.active.values(),
                     key=lambda s: (s.admit_step, -s.req.priority, s.rid))
        self._evict(victim)
        return victim

    def _evict(self, sr: ScheduledRequest) -> None:
        del self.active[sr.rid]
        self.kv.release(sr.rid)
        self._free_slots.append(sr.slot)
        sr.slot = -1
        sr.state = RequestState.PREEMPTED
        sr.n_preempt += 1
        self.waiting.insert(0, sr)      # queue head: resume first

    # -- completion -----------------------------------------------------------------
    def finish(self, sr: ScheduledRequest) -> None:
        del self.active[sr.rid]
        self.kv.release(sr.rid)
        self._free_slots.append(sr.slot)
        sr.slot = -1
        sr.state = RequestState.DONE

    @property
    def idle(self) -> bool:
        return not self.waiting and not self.active
