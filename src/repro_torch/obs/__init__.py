"""Cross-cutting observability: tracing, metrics, stall attribution.

Two pillars plus the report section that joins them to the paper:

  * :mod:`repro_torch.obs.trace` — thread-safe bounded span/event
    tracer with an injectable monotonic clock and Chrome Trace Event JSON
    export (Perfetto / ``chrome://tracing``); the no-op
    :data:`NULL_TRACER` is the default sink everywhere, so tracing costs
    nothing unless asked for;
  * :mod:`repro_torch.obs.metrics` — labelled counter/gauge/histogram
    registry with a JSON-safe ``snapshot()``;
  * :mod:`repro_torch.obs.stall` — measured admission-wait / dispatch-gap
    fractions laid against ``fifo_sim``'s modelled stall cycles: the
    measured half of the §VI bandwidth-efficiency reproduction.
"""
from repro_torch.obs.metrics import (Counter, Gauge,  # noqa: F401
                                     Histogram, MetricsRegistry,
                                     default_registry)
from repro_torch.obs.stall import stall_attribution  # noqa: F401
from repro_torch.obs.trace import (NULL_TRACER, TRACKS,  # noqa: F401
                                   ManualClock, NullTracer, Tracer,
                                   chrome_trace_events, monotonic_clock,
                                   validate_chrome_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_registry", "stall_attribution", "NULL_TRACER", "TRACKS",
    "ManualClock", "NullTracer", "Tracer", "chrome_trace_events",
    "monotonic_clock", "validate_chrome_trace",
]
