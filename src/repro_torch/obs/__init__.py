"""repro_torch.obs — unified tracing, metrics, spans, SLOs, and drift
monitoring (port of ``repro.obs``; every module is a framework-free copy).

The observability layer the planner stack reports through:

  - trace:   ring-buffered typed structured-event tracer (``Tracer``,
             ``enable``/``disable``/``get_tracer``); ``ArenaAllocator``,
             ``ServeEngine``/``Scheduler``, ``remat.search`` and
             ``SharedArena`` emit here when a tracer is active; buffer
             drops warn once and count on the metrics registry;
  - export:  Chrome-trace/Perfetto JSON (``ChromeTraceBuilder``) rendering
             runtime timelines, address×time packing rectangles, and
             request-lifecycle span tracks;
  - metrics: ``MetricsRegistry`` (counters/gauges/histograms) with
             Prometheus-text and JSON exporters; ``ServeMetrics`` stores its
             counters here; ``ManualClock`` for deterministic tests; an
             active-registry hook (``get_registry``/``use_registry``) lets
             entry points aggregate every component into one scrape;
  - spans:   ``SpanTracker`` — folds engine/scheduler events into
             per-request spans (queue/prefill/decode/preempted tilings that
             conserve E2E latency), attributes preemption gaps to
             cause-tagged §4.3 replans, and exports Perfetto duration
             tracks;
  - slo:     ``SLOEngine`` — streaming TTFT/TPOT/E2E histograms
             (``StreamingHistogram`` percentiles), per-class ``SLOSpec``
             attainment, and goodput (tokens from requests that met SLO);
  - drift:   ``DriftMonitor`` — planned profile vs observed events: peak
             ratio, shape drift, fragmentation, headroom, per-cause replan
             counters.

On the card the engine's instants are host times: ``decode`` is stamped
before the step's graph replay is launched, and the ``finish`` of a request
that ends in that step after the token readback that syncs it.  The spans'
and SLOs' step clock does not depend on timing at all.
"""
from .drift import DriftMonitor, live_curve
from .export import (ChromeTraceBuilder, load_chrome_trace, plan_rectangles,
                     validate_chrome_trace)
from .metrics import (Counter, Gauge, Histogram, ManualClock, MetricsRegistry,
                      get_registry, set_registry, use_registry)
from .slo import SLOEngine, SLOSpec, StreamingHistogram
from .spans import RequestSpan, SpanPhase, SpanTracker, summarize_spans
from .trace import (TraceEvent, Tracer, disable, enable, get_tracer,
                    use_tracer)

__all__ = [
    "ChromeTraceBuilder", "Counter", "DriftMonitor", "Gauge", "Histogram",
    "ManualClock", "MetricsRegistry", "RequestSpan", "SLOEngine", "SLOSpec",
    "SpanPhase", "SpanTracker", "StreamingHistogram", "TraceEvent", "Tracer",
    "disable", "enable", "get_registry", "get_tracer", "live_curve",
    "load_chrome_trace", "plan_rectangles", "set_registry", "summarize_spans",
    "use_registry", "use_tracer", "validate_chrome_trace",
]
