"""Request-lifecycle spans folded from the serving tracer's event stream (a
copy of ``repro.obs.spans``).

The tracer (``obs.trace``) records *instants* — enqueue, admit,
prefill-chunk, prefill, decode, preempt, finish — each stamped on both the
wall clock and the engine-step clock.  A :class:`SpanTracker` folds that
stream into one :class:`RequestSpan` per request: an ordered tiling of
:class:`SpanPhase` segments (``queue`` → ``prefill`` → ``decode``, with
``preempted`` gaps between evict and re-admit) whose step-clock lengths sum
*exactly* to the request's end-to-end latency — the conservation invariant
``conservation_violations()`` audits.

Every ``preempted`` phase is attributed to the §4.3 replan request that
caused it: the engine always flags the arena (``replan-request``, cause
``decode-outrun``) before choosing a victim, so the tracker links each gap
to the nearest preceding cause-tagged replan event at the same engine step.
``attribution()`` aggregates the other direction — which replan cause
stalled which requests, and for how many steps — the per-cell table a
load run reports.

Spans export as proper Perfetto duration tracks (one thread per request,
one slice per phase) through ``to_events()`` + ``ChromeTraceBuilder``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional

from .trace import PH_COMPLETE, TraceEvent

#: phase kinds, in canonical lifecycle order
QUEUE, PREFILL, DECODE, PREEMPTED = "queue", "prefill", "decode", "preempted"
PHASE_KINDS = (QUEUE, PREFILL, DECODE, PREEMPTED)

#: event names the tracker understands (cat="serving")
_LIFECYCLE = ("enqueue", "admit", "prefill", "preempt", "finish")


@dataclass
class SpanPhase:
    """One contiguous segment of a request's life on both clocks.

    ``end_step``/``end_ts`` stay ``None`` while the phase is open; a closed
    phase covers ``[start_step, end_step)`` on the engine-step clock.
    ``cause`` is set on ``preempted`` phases: the §4.3 replan cause that
    evicted the request (empty when no replan event could be linked).
    """

    kind: str
    start_step: int
    start_ts: float
    end_step: Optional[int] = None
    end_ts: Optional[float] = None
    cause: str = ""

    @property
    def steps(self) -> int:
        end = self.end_step if self.end_step is not None else self.start_step
        return max(0, end - self.start_step)

    @property
    def dur_us(self) -> float:
        end = self.end_ts if self.end_ts is not None else self.start_ts
        return max(0.0, end - self.start_ts)


@dataclass
class RequestSpan:
    """One request's lifecycle: an ordered tiling of phases."""

    rid: int
    prompt_len: int = 0
    enqueue_step: int = -1
    enqueue_ts: float = 0.0
    finish_step: Optional[int] = None
    finish_ts: Optional[float] = None
    first_token_step: Optional[int] = None
    n_tokens: int = 0
    n_preempt: int = 0
    phases: list[SpanPhase] = field(default_factory=list)
    truncated: bool = False      # opened past a ring-buffer drop horizon

    # -- derived latency metrics (step clock: deterministic) -----------------------
    @property
    def done(self) -> bool:
        return self.finish_step is not None

    @property
    def e2e_steps(self) -> Optional[int]:
        if self.finish_step is None:
            return None
        return self.finish_step - self.enqueue_step

    @property
    def ttft_steps(self) -> Optional[int]:
        if self.first_token_step is None:
            return None
        return self.first_token_step - self.enqueue_step

    @property
    def tpot_steps(self) -> Optional[float]:
        """Steps per output token after the first (decode cadence)."""
        if self.finish_step is None or self.first_token_step is None:
            return None
        if self.n_tokens <= 1:
            return 0.0
        return (self.finish_step - self.first_token_step) / (self.n_tokens - 1)

    def breakdown(self) -> dict:
        """Steps spent per phase kind; sums to ``e2e_steps`` when done."""
        out = {k: 0 for k in PHASE_KINDS}
        for p in self.phases:
            out[p.kind] += p.steps
        return out

    def conserved(self) -> bool:
        """The conservation invariant: the phase tiling covers [enqueue,
        finish) exactly — no gap, no double-count."""
        if not self.done:
            return True
        total = sum(self.breakdown().values())
        return total == self.e2e_steps and self._tiles()

    def _tiles(self) -> bool:
        prev = self.enqueue_step
        for p in self.phases:
            if p.start_step != prev or p.end_step is None:
                return False
            prev = p.end_step
        return prev == self.finish_step

    def stall_steps_by_cause(self) -> dict:
        out: dict[str, int] = {}
        for p in self.phases:
            if p.kind == PREEMPTED:
                key = p.cause or "unattributed"
                out[key] = out.get(key, 0) + p.steps
        return out


class SpanTracker:
    """Folds serving trace events into per-request spans.

    Feed it events (all categories are fine — it reads ``serving`` lifecycle
    instants and cause-tagged ``replan-request`` instants from any
    category) either incrementally or in one call::

        tracker = SpanTracker()
        tracker.feed(tracer.events())
        for span in tracker.finished():
            assert span.conserved()
    """

    def __init__(self):
        self.spans: dict[int, RequestSpan] = {}
        self._last_replan: Optional[tuple[int, str]] = None  # (step, cause)
        self.n_ignored = 0       # events for rids lost to ring-buffer drops

    # -- feeding ------------------------------------------------------------------
    def feed(self, events: Iterable[TraceEvent]) -> "SpanTracker":
        for ev in events:
            if ev.name == "replan-request":
                self._last_replan = (ev.step, ev.args.get("cause", ""))
            elif ev.cat == "serving" and ev.name in _LIFECYCLE:
                self._lifecycle(ev)
        return self

    def _lifecycle(self, ev: TraceEvent) -> None:
        rid = ev.args.get("rid")
        if rid is None:
            return
        span = self.spans.get(rid)
        if ev.name == "enqueue":
            span = RequestSpan(rid=rid,
                               prompt_len=ev.args.get("prompt_len", 0),
                               enqueue_step=ev.step, enqueue_ts=ev.ts)
            span.phases.append(SpanPhase(QUEUE, ev.step, ev.ts))
            self.spans[rid] = span
            return
        if span is None:
            # the enqueue fell off the ring buffer: open a truncated span so
            # later events still land somewhere (excluded from conservation)
            span = RequestSpan(rid=rid, enqueue_step=ev.step, enqueue_ts=ev.ts,
                               truncated=True)
            span.phases.append(SpanPhase(QUEUE, ev.step, ev.ts))
            self.spans[rid] = span
            self.n_ignored += 1
        if ev.name == "admit":
            self._close(span, ev)
            span.phases.append(SpanPhase(PREFILL, ev.step, ev.ts))
        elif ev.name == "prefill":
            # the model prefill call: prefill ends, the first token is
            # produced here, decode begins
            self._close(span, ev)
            if span.first_token_step is None:
                span.first_token_step = ev.step
            span.phases.append(SpanPhase(DECODE, ev.step, ev.ts))
        elif ev.name == "preempt":
            self._close(span, ev)
            cause = ""
            if self._last_replan is not None and \
                    self._last_replan[0] == ev.step:
                cause = self._last_replan[1]
            span.phases.append(SpanPhase(PREEMPTED, ev.step, ev.ts,
                                         cause=cause))
            span.n_preempt += 1
        elif ev.name == "finish":
            self._close(span, ev)
            span.finish_step = ev.step
            span.finish_ts = ev.ts
            span.n_tokens = ev.args.get("n_tokens", 0)

    @staticmethod
    def _close(span: RequestSpan, ev: TraceEvent) -> None:
        if span.phases and span.phases[-1].end_step is None:
            span.phases[-1].end_step = ev.step
            span.phases[-1].end_ts = ev.ts

    # -- inspection ---------------------------------------------------------------
    def finished(self) -> list[RequestSpan]:
        return [s for s in self.spans.values()
                if s.done and not s.truncated]

    def all_spans(self) -> list[RequestSpan]:
        return list(self.spans.values())

    def conservation_violations(self) -> list[int]:
        """rids of finished spans whose phase tiling does NOT sum to E2E —
        always empty unless the event stream itself is corrupt."""
        return [s.rid for s in self.finished() if not s.conserved()]

    def attribution(self) -> dict:
        """The replan-cause table: which cause stalled which requests, for
        how many preemptions and steps in total."""
        table: dict[str, dict] = {}
        for s in self.spans.values():
            for p in s.phases:
                if p.kind != PREEMPTED:
                    continue
                key = p.cause or "unattributed"
                row = table.setdefault(key, {"n_preemptions": 0,
                                             "stall_steps": 0, "rids": []})
                row["n_preemptions"] += 1
                row["stall_steps"] += p.steps
                if s.rid not in row["rids"]:
                    row["rids"].append(s.rid)
        for row in table.values():
            row["rids"].sort()
        return table

    # -- export -------------------------------------------------------------------
    def to_events(self, cat: str = "requests") -> list[TraceEvent]:
        """Spans as Perfetto duration tracks: one thread per request, one
        complete slice per phase (wall-clock ts/dur; step bounds and replan
        cause ride in args).  Feed to ``ChromeTraceBuilder.add_events``."""
        out: list[TraceEvent] = []
        for rid in sorted(self.spans):
            s = self.spans[rid]
            track = f"req {rid}"
            for p in s.phases:
                args = {"rid": rid, "start_step": p.start_step,
                        "end_step": (p.end_step if p.end_step is not None
                                     else p.start_step),
                        "steps": p.steps}
                if p.kind == PREEMPTED:
                    args["cause"] = p.cause or "unattributed"
                out.append(TraceEvent(name=p.kind, cat=cat, ph=PH_COMPLETE,
                                      ts=p.start_ts, step=p.start_step,
                                      track=track, dur=p.dur_us, args=args))
        out.sort(key=lambda e: (e.ts, e.args["rid"]))
        return out


def summarize_spans(spans: Iterable[RequestSpan]) -> dict:
    """Aggregate breakdown across finished spans (benchmark convenience)."""
    done = [s for s in spans if s.done and not s.truncated]
    totals = {k: 0 for k in PHASE_KINDS}
    for s in done:
        for k, v in s.breakdown().items():
            totals[k] += v
    return {
        "n_finished": len(done),
        "total_steps_by_phase": totals,
        "total_e2e_steps": sum(s.e2e_steps for s in done),
        "n_preemptions": sum(s.n_preempt for s in done),
        "conservation_violations": [s.rid for s in done if not s.conserved()],
    }
