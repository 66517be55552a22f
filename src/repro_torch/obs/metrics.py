"""Metrics registry: counters, gauges, histograms, two exporters.

Zero-dep Prometheus-flavoured metrics.  A :class:`MetricsRegistry` owns
named metric instances (optionally labelled) and renders them as either
Prometheus text exposition format (``to_prometheus_text``) or a plain JSON
dict (``to_json``).  ``ServeMetrics`` stores its scalar counters here;
drivers dump the registry with ``--metrics``.

``ManualClock`` is the companion fake clock: inject it wherever a component
takes a ``clock`` callable (``ServeMetrics``, ``Tracer``) to make wall-time
derived numbers reproducible in tests.
"""
from __future__ import annotations

import json
import math
from contextlib import contextmanager
from typing import Iterator, Optional, Sequence

DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                   10.0, 25.0, 50.0, 100.0)


class ManualClock:
    """Deterministic clock: returns seconds, advanced explicitly."""

    def __init__(self, start: float = 0.0, tick: float = 0.0):
        """``tick``: seconds auto-advanced per call (0 = fully manual)."""
        self.t = start
        self.tick = tick

    def __call__(self) -> float:
        t = self.t
        self.t += self.tick
        return t

    def advance(self, seconds: float) -> None:
        self.t += seconds


def _render_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "", labels: Optional[dict] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})


class Counter(_Metric):
    """Monotonically increasing count (``set`` exists for state migration)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "", labels: Optional[dict] = None):
        super().__init__(name, help, labels)
        self.value: float = 0

    def inc(self, amount: float = 1) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up (inc {amount})")
        self.value += amount

    def set(self, value: float) -> None:
        """Direct assignment — for components migrating existing counts."""
        self.value = value


class Gauge(_Metric):
    """A value that can go anywhere; ``set_max`` tracks a high-water mark."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "", labels: Optional[dict] = None):
        super().__init__(name, help, labels)
        self.value: float = 0

    def set(self, value: float) -> None:
        self.value = value

    def inc(self, amount: float = 1) -> None:
        self.value += amount

    def dec(self, amount: float = 1) -> None:
        self.value -= amount

    def set_max(self, value: float) -> None:
        self.value = max(self.value, value)


class Histogram(_Metric):
    """Cumulative-bucket histogram with sum/count/min/max/mean."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", labels: Optional[dict] = None,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labels)
        self.buckets = tuple(sorted(buckets))
        self.bucket_counts = [0] * len(self.buckets)
        self.sum: float = 0.0
        self.count: int = 0
        self.min: float = math.inf
        self.max: float = -math.inf

    def observe(self, value: float) -> None:
        self.sum += value
        self.count += 1
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        for i, le in enumerate(self.buckets):
            if value <= le:
                self.bucket_counts[i] += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MetricsRegistry:
    """Get-or-create registry of metrics, keyed by (name, labels)."""

    def __init__(self):
        self._metrics: dict[tuple, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labels: Optional[dict], **kw):
        key = (name, tuple(sorted((labels or {}).items())))
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, help=help, labels=labels, **kw)
            self._metrics[key] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as {m.kind}")
        return m

    def counter(self, name: str, help: str = "",
                labels: Optional[dict] = None) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[dict] = None) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[dict] = None,
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def metrics(self) -> list[_Metric]:
        return list(self._metrics.values())

    # -- exporters ---------------------------------------------------------------
    def to_prometheus_text(self) -> str:
        """Prometheus text exposition format (scrape-ready)."""
        lines: list[str] = []
        seen_headers: set[str] = set()
        for m in self._metrics.values():
            if m.name not in seen_headers:
                seen_headers.add(m.name)
                if m.help:
                    lines.append(f"# HELP {m.name} {m.help}")
                lines.append(f"# TYPE {m.name} {m.kind}")
            lab = _render_labels(m.labels)
            if isinstance(m, Histogram):
                # bucket_counts are cumulative (observe() fills every le >= v)
                for le, c in zip(m.buckets, m.bucket_counts):
                    blab = dict(m.labels, le=repr(float(le)))
                    lines.append(
                        f"{m.name}_bucket{_render_labels(blab)} {c}")
                inf_lab = dict(m.labels, le="+Inf")
                lines.append(f"{m.name}_bucket{_render_labels(inf_lab)} {m.count}")
                lines.append(f"{m.name}_sum{lab} {m.sum}")
                lines.append(f"{m.name}_count{lab} {m.count}")
            else:
                lines.append(f"{m.name}{lab} {m.value}")
        return "\n".join(lines) + "\n"

    def to_json(self) -> dict:
        """Plain-dict dump (benchmarks attach this to their BENCH_*.json)."""
        out: dict = {}
        for m in self._metrics.values():
            key = m.name + _render_labels(m.labels)
            if isinstance(m, Histogram):
                out[key] = {
                    "kind": m.kind, "count": m.count, "sum": m.sum,
                    "mean": m.mean,
                    "min": None if m.count == 0 else m.min,
                    "max": None if m.count == 0 else m.max,
                    "buckets": {repr(float(le)): c for le, c in
                                zip(m.buckets, m.bucket_counts)},
                }
            else:
                out[key] = {"kind": m.kind, "value": m.value}
        return out

    def to_json_text(self) -> str:
        return json.dumps(self.to_json(), indent=2, sort_keys=True)


# -- module-global active registry ----------------------------------------------
# Mirrors the tracer's active-instance pattern: drivers (launch/*, the bench
# orchestrator's --metrics flag) install one registry, and components that
# default their ``registry`` argument (``ServeMetrics``, the tracer's drop
# counter) aggregate into it instead of each owning a private scrape.
_ACTIVE: Optional[MetricsRegistry] = None


def get_registry() -> Optional[MetricsRegistry]:
    """The active registry, or None (components fall back to private ones)."""
    return _ACTIVE


def set_registry(registry: Optional[MetricsRegistry]) -> Optional[MetricsRegistry]:
    """Install (or clear, with None) the active registry; returns the
    previous one so callers can restore it."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, registry
    return prev


@contextmanager
def use_registry(registry: MetricsRegistry) -> Iterator[MetricsRegistry]:
    """Temporarily install ``registry`` as the active one."""
    prev = set_registry(registry)
    try:
        yield registry
    finally:
        set_registry(prev)
