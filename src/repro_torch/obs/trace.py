"""Typed structured-event tracer for the planner stack.

Zero-dep, ring-buffered, and stamped on two clocks at once: the wall clock
(injectable, so tests are deterministic) and the *step* clock of whatever
subsystem is emitting (engine step, arena iteration, search round).  The
instrumented modules — ``ArenaAllocator``, ``ServeEngine``/``Scheduler``,
``remat.search``, ``SharedArena`` — emit through the module-global active
tracer; when none is installed every hook is a single ``None`` check, so the
hot paths stay O(1).

Typical use::

    from repro_torch.obs import trace as obs_trace
    tracer = obs_trace.enable()
    ... run the engine ...
    events = tracer.events()           # list[TraceEvent], oldest dropped first
    obs_trace.disable()

Categories double as Chrome-trace processes (see ``obs.export``): "arena",
"serving", "remat", "unified".  Tracks become threads within a process —
tenants, scheduler, engine, individual decode slots.
"""
from __future__ import annotations

import time
import warnings
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional

from . import metrics as _metrics

DEFAULT_CAPACITY = 65_536

# Phases mirror the Chrome trace event format: instant, complete, counter.
PH_INSTANT = "i"
PH_COMPLETE = "X"
PH_COUNTER = "C"


@dataclass(frozen=True)
class TraceEvent:
    """One structured event: what happened, where, and on both clocks."""

    name: str                 # e.g. "replan", "admit", "shrink-round"
    cat: str                  # subsystem: "arena" | "serving" | "remat" | "unified"
    ph: str                   # PH_INSTANT | PH_COMPLETE | PH_COUNTER
    ts: float                 # microseconds since tracer start (wall clock)
    step: int                 # subsystem step stamp (-1 = unknown)
    track: str = "main"       # logical thread within the subsystem
    dur: float = 0.0          # microseconds (PH_COMPLETE only)
    args: dict = field(default_factory=dict)


class Tracer:
    """Ring buffer of :class:`TraceEvent` with drop accounting.

    ``clock`` returns seconds (monotonic); inject a fake for determinism.
    ``capacity`` bounds memory: the oldest events are dropped, and
    ``n_dropped`` says how many — exporters surface it so a truncated trace
    never silently reads as a complete one.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 clock: Callable[[], float] = time.perf_counter,
                 registry: Optional["_metrics.MetricsRegistry"] = None):
        """``registry``: where the drop counter is surfaced
        (``trace_dropped_events_total``).  Defaults to the active registry
        (``obs.metrics.get_registry()``) at first-drop time, so long
        scenario runs can't silently lose spans."""
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._clock = clock
        self._t0 = clock()
        self._ring: deque[TraceEvent] = deque(maxlen=capacity)
        self.n_emitted = 0
        self.step = -1          # current step stamp; see set_step()
        self._registry = registry
        self._drop_counter = None
        self._warned_drop = False

    # -- clocks -----------------------------------------------------------------
    def now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def set_step(self, step: int) -> None:
        """Stamp subsequent events with this subsystem step."""
        self.step = step

    # -- emission ---------------------------------------------------------------
    def emit(self, event: TraceEvent) -> None:
        if len(self._ring) == self.capacity:
            self._on_drop()
        self._ring.append(event)
        self.n_emitted += 1

    def _on_drop(self) -> None:
        """The ring is full: the oldest event is about to be lost.  Warn
        once (so a long scenario run never silently truncates its spans)
        and count every drop on the metrics registry."""
        if not self._warned_drop:
            self._warned_drop = True
            warnings.warn(
                f"Tracer ring buffer full (capacity={self.capacity}): "
                "oldest events are being dropped; exported spans may be "
                "truncated.  Raise Tracer(capacity=...) for long runs.",
                RuntimeWarning, stacklevel=4)
        if self._drop_counter is None:
            reg = self._registry if self._registry is not None \
                else _metrics.get_registry()
            if reg is None:
                return
            self._drop_counter = reg.counter(
                "trace_dropped_events_total",
                "trace events dropped by the ring buffer")
        self._drop_counter.inc()

    def instant(self, name: str, cat: str, track: str = "main",
                **args) -> None:
        self.emit(TraceEvent(name=name, cat=cat, ph=PH_INSTANT,
                             ts=self.now_us(), step=self.step, track=track,
                             args=args))

    def complete(self, name: str, cat: str, track: str, ts: float,
                 dur: float, **args) -> None:
        self.emit(TraceEvent(name=name, cat=cat, ph=PH_COMPLETE, ts=ts,
                             step=self.step, track=track, dur=dur, args=args))

    def counter(self, name: str, cat: str, value: float,
                track: str = "counters") -> None:
        self.emit(TraceEvent(name=name, cat=cat, ph=PH_COUNTER,
                             ts=self.now_us(), step=self.step, track=track,
                             args={"value": value}))

    @contextmanager
    def span(self, name: str, cat: str, track: str = "main",
             **args) -> Iterator[None]:
        """Emit a PH_COMPLETE slice covering the with-block."""
        t0 = self.now_us()
        try:
            yield
        finally:
            self.complete(name, cat, track, ts=t0,
                          dur=max(0.0, self.now_us() - t0), **args)

    # -- inspection ---------------------------------------------------------------
    @property
    def n_dropped(self) -> int:
        return self.n_emitted - len(self._ring)

    def events(self) -> list[TraceEvent]:
        return list(self._ring)

    def stats(self) -> dict:
        return {"capacity": self.capacity, "n_emitted": self.n_emitted,
                "n_buffered": len(self._ring), "n_dropped": self.n_dropped}


# -- module-global active tracer ------------------------------------------------
_ACTIVE: Optional[Tracer] = None


def get_tracer() -> Optional[Tracer]:
    """The active tracer, or None (instrumentation hooks check this)."""
    return _ACTIVE


def enable(tracer: "Tracer | int" = DEFAULT_CAPACITY,
           clock: Callable[[], float] = time.perf_counter) -> Tracer:
    """Install (and return) the active tracer.

    Pass a ``Tracer`` to install it, or a capacity int (the default) to
    build a fresh one."""
    global _ACTIVE
    if not isinstance(tracer, Tracer):
        tracer = Tracer(capacity=tracer, clock=clock)
    _ACTIVE = tracer
    return _ACTIVE


def disable() -> Optional[Tracer]:
    """Uninstall the active tracer; returns it for a final export."""
    global _ACTIVE
    t, _ACTIVE = _ACTIVE, None
    return t


@contextmanager
def use_tracer(tracer: Tracer) -> Iterator[Tracer]:
    """Temporarily install ``tracer`` as the active one (test helper)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tracer
    try:
        yield tracer
    finally:
        _ACTIVE = prev
