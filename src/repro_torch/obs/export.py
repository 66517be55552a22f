"""Chrome-trace / Perfetto JSON export for runtime events AND packings (a
copy of ``repro.obs.export``; the exporter tag reads ``repro_torch.obs``).

Two renderings share one builder:

  * **runtime timelines** — the tracer's structured events become slices and
    instants; each category ("serving", "arena", "unified", "remat") is a
    Chrome *process*, each track (tenant, scheduler, slot) a *thread*;
  * **the packing itself** — any ``MemoryProfile`` + ``AllocationPlan``
    renders as address×time rectangles: every block becomes a complete
    slice whose thread is its planned *offset* (one track per distinct
    address), so a plan is literally inspectable in ``chrome://tracing`` /
    https://ui.perfetto.dev.  Plan validity guarantees two blocks sharing a
    track (same offset) never overlap in time — the exported view inherits
    the no-overlap invariant, which ``plan_rectangles`` lets a reader
    re-check from the export alone.

The emitted JSON is the standard ``{"traceEvents": [...]}`` object format;
``validate_chrome_trace`` is the schema gate used by tests and benchmarks.
"""
from __future__ import annotations

import json
from typing import Iterable, Optional

from ..core.bestfit import best_fit
from ..core.events import MemoryProfile

from .trace import PH_COMPLETE, PH_COUNTER, PH_INSTANT, TraceEvent

# One profile clock tick rendered as this many trace microseconds.
DEFAULT_TICK_US = 1_000.0


class ChromeTraceBuilder:
    """Accumulates trace events + plan rectangles into one Chrome JSON."""

    def __init__(self):
        self._events: list[dict] = []
        self._meta: list[dict] = []
        self._pids: dict[str, int] = {}
        self._tids: dict[tuple, int] = {}

    # -- process/thread bookkeeping ----------------------------------------------
    def _pid(self, process: str) -> int:
        pid = self._pids.get(process)
        if pid is None:
            pid = len(self._pids) + 1
            self._pids[process] = pid
            self._meta.append({"name": "process_name", "ph": "M", "pid": pid,
                               "tid": 0, "ts": 0,
                               "args": {"name": process}})
        return pid

    def _tid(self, process: str, track: str, *,
             name: Optional[str] = None) -> int:
        pid = self._pid(process)
        key = (process, track)
        tid = self._tids.get(key)
        if tid is None:
            tid = sum(1 for k in self._tids if k[0] == process) + 1
            self._tids[key] = tid
            self._meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                               "tid": tid, "ts": 0,
                               "args": {"name": name or track}})
        return tid

    # -- runtime events -----------------------------------------------------------
    def add_events(self, events: Iterable[TraceEvent]) -> "ChromeTraceBuilder":
        """Render tracer events; ``cat`` becomes the process, ``track`` the
        thread, and the subsystem step rides along in ``args.step``."""
        for ev in events:
            pid = self._pid(ev.cat)
            tid = self._tid(ev.cat, ev.track)
            entry = {"name": ev.name, "cat": ev.cat, "ph": ev.ph,
                     "ts": ev.ts, "pid": pid, "tid": tid,
                     "args": dict(ev.args, step=ev.step)}
            if ev.ph == PH_COMPLETE:
                entry["dur"] = ev.dur
            elif ev.ph == PH_INSTANT:
                entry["s"] = "t"
            elif ev.ph == PH_COUNTER:
                entry["args"] = {ev.name: ev.args.get("value", 0)}
            self._events.append(entry)
        return self

    # -- packing rectangles ---------------------------------------------------------
    def add_plan(self, name: str, profile: MemoryProfile, plan=None, *,
                 solver=best_fit,
                 tick_us: float = DEFAULT_TICK_US) -> "ChromeTraceBuilder":
        """Render a packed plan as address×time rectangles.

        Tracks are the distinct planned offsets (low addresses first), so
        the Perfetto row order reads like the DSA plane; each slice's args
        carry the exact ``offset``/``size``/``bid`` so the packing can be
        reconstructed (and re-validated) from the export alone.
        """
        if plan is None:
            plan = solver(profile)
        blocks = [b for b in profile.blocks if b.size > 0]
        # dense track ids, ordered by address: track k <=> k-th lowest offset
        offsets = sorted({plan.offsets[b.bid] for b in blocks})
        lane = {off: i for i, off in enumerate(offsets)}
        pid = self._pid(f"plan:{name}")
        for off in offsets:
            self._tid(f"plan:{name}", f"addr:{off}",
                      name=f"0x{off:08x}")
        for b in sorted(blocks, key=lambda b: (b.start, b.bid)):
            off = plan.offsets[b.bid]
            self._events.append({
                "name": b.tag or f"b{b.bid}",
                "cat": "packing",
                "ph": PH_COMPLETE,
                "ts": b.start * tick_us,
                "dur": b.lifetime * tick_us,
                "pid": pid,
                "tid": self._tids[(f"plan:{name}", f"addr:{off}")],
                "args": {"bid": b.bid, "offset": off, "size": b.size,
                         "start": b.start, "end": b.end, "lane": lane[off],
                         "peak": plan.peak},
            })
        return self

    # -- output ---------------------------------------------------------------------
    def build(self, *, meta: Optional[dict] = None) -> dict:
        """Assemble the Chrome JSON object; events sorted by ``ts``."""
        events = sorted(self._events, key=lambda e: (e["ts"], e["pid"],
                                                     e["tid"]))
        return {
            "traceEvents": self._meta + events,
            "displayTimeUnit": "ms",
            "otherData": dict(meta or {}, exporter="repro_torch.obs"),
        }

    def write(self, path: str, *, meta: Optional[dict] = None) -> dict:
        trace = self.build(meta=meta)
        with open(path, "w") as f:
            json.dump(trace, f)
        return trace


def validate_chrome_trace(trace: dict) -> None:
    """Schema gate: the invariants Perfetto/chrome://tracing rely on.

    Raises ``ValueError`` on the first violation.  Checked: object format
    with a ``traceEvents`` list; every event carries name/ph/pid/tid/ts;
    complete events carry a non-negative ``dur``; non-metadata events are
    sorted by ``ts`` (the builder guarantees it, loaders appreciate it).
    """
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("not an object-format trace: missing 'traceEvents'")
    events = trace["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError("'traceEvents' must be a non-empty list")
    last_ts = None
    for i, ev in enumerate(events):
        for key in ("name", "ph", "pid", "tid", "ts"):
            if key not in ev:
                raise ValueError(f"event {i} missing required key {key!r}")
        if not isinstance(ev["ts"], (int, float)):
            raise ValueError(f"event {i}: non-numeric ts {ev['ts']!r}")
        if ev["ph"] == "M":
            continue
        if ev["ph"] == PH_COMPLETE:
            if "dur" not in ev or ev["dur"] < 0:
                raise ValueError(f"event {i}: complete event needs dur >= 0")
        if last_ts is not None and ev["ts"] < last_ts:
            raise ValueError(
                f"event {i}: ts {ev['ts']} < previous {last_ts} (unsorted)")
        last_ts = ev["ts"]


def load_chrome_trace(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def plan_rectangles(trace: dict, name: str) -> list[dict]:
    """Extract the address×time rectangles of plan ``name`` from an export
    (the args the builder embedded) — the reconstruction half of the
    round-trip the tests validate."""
    out = []
    for ev in trace["traceEvents"]:
        if ev.get("cat") == "packing" and ev.get("ph") == PH_COMPLETE:
            args = ev.get("args", {})
            if "offset" in args and "size" in args:
                out.append({"tid": ev["tid"], "pid": ev["pid"], **args})
    if name is not None:
        pids = {e["pid"] for e in trace["traceEvents"]
                if e.get("ph") == "M" and e.get("name") == "process_name"
                and e.get("args", {}).get("name") == f"plan:{name}"}
        out = [r for r in out if r["pid"] in pids]
    return out
