"""SLO attainment and goodput from streaming latency histograms (a copy of
``repro.obs.slo``).

The serving stack's headline question is not "what was the peak" but "what
fraction of traffic met its latency objective, and how many useful tokens
per second did that traffic produce".  This module answers it from the
request spans (``obs.spans``) or raw latency observations:

  * :class:`StreamingHistogram` — geometric-bucket streaming histogram with
    bounded relative error; ``quantile()`` interpolates percentiles without
    retaining samples, so a scenario run can stream millions of requests in
    O(buckets) memory.  Accuracy against ``numpy.quantile`` is pinned by
    ``tests/test_torch_obs.py`` (against the reference's histogram).
  * :class:`SLOSpec` — a per-class objective: TTFT / TPOT / E2E ceilings on
    the engine-step clock (deterministic; multiply by the measured step time
    to convert to seconds).
  * :class:`SLOEngine` — observes finished requests, maintains per-class
    TTFT/TPOT/E2E histograms + attainment counters on a
    ``MetricsRegistry``, and reports percentiles, per-class attainment, and
    *goodput*: tokens produced by requests that met their SLO (the
    ROADMAP's "goodput under churn, not just peaks" number).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, Optional

from .metrics import MetricsRegistry

DEFAULT_QUANTILES = (0.5, 0.9, 0.95, 0.99)


class StreamingHistogram:
    """Geometric buckets: value v lands in bucket ``floor(log_g(v/v0))``.

    Relative quantile error is bounded by ``growth - 1`` (default 4%); the
    first bucket absorbs everything at or below ``min_value`` (zeros are
    common on the step clock).  Sparse storage: only touched buckets exist.
    """

    def __init__(self, min_value: float = 0.5, growth: float = 1.04):
        if growth <= 1.0:
            raise ValueError(f"growth must be > 1, got {growth}")
        self.min_value = min_value
        self.growth = growth
        self._log_g = math.log(growth)
        self._counts: dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def _index(self, value: float) -> int:
        if value <= self.min_value:
            return 0
        return 1 + int(math.log(value / self.min_value) / self._log_g)

    def observe(self, value: float) -> None:
        if value < 0:
            raise ValueError(f"negative latency {value}")
        i = self._index(value)
        self._counts[i] = self._counts.get(i, 0) + 1
        self.count += 1
        self.sum += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def _bucket_value(self, index: int) -> float:
        if index == 0:
            return self.min_value
        # geometric midpoint of the bucket's edges
        lo = self.min_value * self.growth ** (index - 1)
        return lo * math.sqrt(self.growth)

    def quantile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (None when empty); clamped to observed
        min/max so tiny histograms never extrapolate."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return None
        rank = q * (self.count - 1)
        acc = 0
        for i in sorted(self._counts):
            acc += self._counts[i]
            if acc > rank:
                # bucket 0 absorbs everything <= min_value; the tracked
                # minimum is its most honest representative (zeros are the
                # common case on the step clock)
                v = self.min if i == 0 else self._bucket_value(i)
                return min(max(v, self.min), self.max)
        return self.max

    def quantiles(self, qs: Iterable[float] = DEFAULT_QUANTILES) -> dict:
        return {f"p{round(q * 100):02d}": self.quantile(q) for q in qs}

    def to_dict(self) -> dict:
        return {"count": self.count, "sum": self.sum, "mean": self.mean,
                "min": None if self.count == 0 else self.min,
                "max": None if self.count == 0 else self.max,
                **self.quantiles()}


@dataclass(frozen=True)
class SLOSpec:
    """Latency objective for one traffic class, on the engine-step clock.

    ``None`` disables a ceiling.  ``ttft_steps`` bounds enqueue -> first
    token; ``tpot_steps`` bounds the mean decode cadence after the first
    token; ``e2e_steps`` bounds enqueue -> finish.
    """

    name: str = "default"
    ttft_steps: Optional[float] = None
    tpot_steps: Optional[float] = None
    e2e_steps: Optional[float] = None

    def met(self, ttft: Optional[float], tpot: Optional[float],
            e2e: Optional[float]) -> bool:
        if self.ttft_steps is not None and \
                (ttft is None or ttft > self.ttft_steps):
            return False
        if self.tpot_steps is not None and \
                (tpot is None or tpot > self.tpot_steps):
            return False
        if self.e2e_steps is not None and \
                (e2e is None or e2e > self.e2e_steps):
            return False
        return True

    def to_dict(self) -> dict:
        return {"name": self.name, "ttft_steps": self.ttft_steps,
                "tpot_steps": self.tpot_steps, "e2e_steps": self.e2e_steps}


class _ClassState:
    def __init__(self, spec: SLOSpec, registry: MetricsRegistry):
        self.spec = spec
        self.ttft = StreamingHistogram()
        self.tpot = StreamingHistogram(min_value=0.05)
        self.e2e = StreamingHistogram()
        labels = {"slo_class": spec.name}
        self.c_total = registry.counter(
            "slo_requests_total", "finished requests observed", labels)
        self.c_met = registry.counter(
            "slo_requests_met_total", "requests that met their SLO", labels)
        self.c_tokens = registry.counter(
            "slo_tokens_total", "tokens from finished requests", labels)
        self.c_good = registry.counter(
            "slo_goodput_tokens_total",
            "tokens from requests that met their SLO", labels)


class SLOEngine:
    """Per-class SLO attainment + goodput, fed finished request spans."""

    def __init__(self, specs: "SLOSpec | Iterable[SLOSpec]",
                 registry: Optional[MetricsRegistry] = None,
                 default_class: str = "default"):
        if isinstance(specs, SLOSpec):
            specs = [specs]
        self.registry = registry if registry is not None else MetricsRegistry()
        self.classes: dict[str, _ClassState] = {
            s.name: _ClassState(s, self.registry) for s in specs}
        if not self.classes:
            raise ValueError("SLOEngine needs at least one SLOSpec")
        self.default_class = default_class if default_class in self.classes \
            else next(iter(self.classes))
        # overall (cross-class) percentile view for the headline report
        self._ttft = StreamingHistogram()
        self._tpot = StreamingHistogram(min_value=0.05)
        self._e2e = StreamingHistogram()

    # -- observation --------------------------------------------------------------
    def observe(self, *, ttft_steps: Optional[float],
                tpot_steps: Optional[float], e2e_steps: Optional[float],
                tokens: int, slo_class: Optional[str] = None) -> bool:
        """Record one finished request; returns whether it met its SLO."""
        cs = self.classes.get(slo_class or self.default_class)
        if cs is None:
            cs = self.classes[self.default_class]
        if ttft_steps is not None:
            cs.ttft.observe(ttft_steps)
            self._ttft.observe(ttft_steps)
        if tpot_steps is not None:
            cs.tpot.observe(tpot_steps)
            self._tpot.observe(tpot_steps)
        if e2e_steps is not None:
            cs.e2e.observe(e2e_steps)
            self._e2e.observe(e2e_steps)
        met = cs.spec.met(ttft_steps, tpot_steps, e2e_steps)
        cs.c_total.inc()
        cs.c_tokens.inc(tokens)
        if met:
            cs.c_met.inc()
            cs.c_good.inc(tokens)
        return met

    def observe_span(self, span, slo_class: Optional[str] = None) -> bool:
        """Convenience for ``obs.spans.RequestSpan`` objects."""
        return self.observe(ttft_steps=span.ttft_steps,
                            tpot_steps=span.tpot_steps,
                            e2e_steps=span.e2e_steps,
                            tokens=span.n_tokens, slo_class=slo_class)

    def observe_spans(self, spans, classes: Optional[dict] = None) -> int:
        """Observe every finished span; ``classes`` maps rid -> class name.
        Returns how many met their SLO."""
        met = 0
        for s in spans:
            if not s.done or s.truncated:
                continue
            cls = (classes or {}).get(s.rid)
            met += bool(self.observe_span(s, slo_class=cls))
        return met

    # -- reporting ----------------------------------------------------------------
    def report(self, *, n_steps: Optional[int] = None,
               wall_s: Optional[float] = None) -> dict:
        """Percentiles, attainment, and goodput.

        ``n_steps`` yields the deterministic ``goodput_tokens_per_step``;
        ``wall_s`` adds the wall-clock ``goodput_tokens_per_s``.
        """
        per_class = {}
        total = met = tokens = good = 0
        for name, cs in self.classes.items():
            n = int(cs.c_total.value)
            m = int(cs.c_met.value)
            per_class[name] = {
                "spec": cs.spec.to_dict(),
                "n_requests": n,
                "n_met": m,
                "attainment": (m / n) if n else None,
                "tokens": int(cs.c_tokens.value),
                "goodput_tokens": int(cs.c_good.value),
                "ttft_steps": cs.ttft.to_dict(),
                "tpot_steps": cs.tpot.to_dict(),
                "e2e_steps": cs.e2e.to_dict(),
            }
            total += n
            met += m
            tokens += int(cs.c_tokens.value)
            good += int(cs.c_good.value)
        out = {
            "n_requests": total,
            "n_met": met,
            "attainment": (met / total) if total else None,
            "tokens": tokens,
            "goodput_tokens": good,
            "ttft_steps": self._ttft.to_dict(),
            "tpot_steps": self._tpot.to_dict(),
            "e2e_steps": self._e2e.to_dict(),
            "classes": per_class,
        }
        if n_steps:
            out["n_steps"] = n_steps
            out["tokens_per_step"] = tokens / n_steps
            out["goodput_tokens_per_step"] = good / n_steps
        if wall_s:
            out["wall_s"] = wall_s
            out["tokens_per_s"] = tokens / wall_s
            out["goodput_tokens_per_s"] = good / wall_s
        return out
