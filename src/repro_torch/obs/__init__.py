"""repro_torch.obs — structured-event tracer and metrics registry (copies of
``repro.obs.trace`` and ``repro.obs.metrics``)."""
from .metrics import (Counter, Gauge, Histogram, ManualClock, MetricsRegistry,
                      get_registry, use_registry)
from .trace import (TraceEvent, Tracer, disable, enable, get_tracer,
                    use_tracer)

__all__ = ["Counter", "Gauge", "Histogram", "ManualClock", "MetricsRegistry",
           "TraceEvent", "Tracer", "disable", "enable", "get_registry",
           "get_tracer", "use_registry", "use_tracer"]
