"""The port's obs layer (counterpart: the reference package's obs/).

- :class:`~repro_torch.obs.tracing.Tracer` — thread-safe Chrome
  trace-event JSON, one lane per thread; ``NULL_TRACER`` is the shared
  no-op, so a disabled hot path costs one attribute read.
- :class:`~repro_torch.obs.metrics.MetricsRegistry` — counters, gauges
  and histograms behind ``ServingEngine.metrics_snapshot()`` and its
  Prometheus text.
- :func:`~repro_torch.obs.trace_analysis.achieved_overlap_fraction` —
  the span-interval half of the async host stage's overlap cross-check.

The spans are host wall-clock spans (``time.perf_counter``), the same
values that feed the planes' ``dispatch_sync_s`` / ``host_stage_s`` and
the worker's ``busy_s``; none of them synchronises the device.
"""
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace_analysis import achieved_overlap_fraction
from repro_torch.obs.tracing import NULL_TRACER, NullTracer, Tracer

__all__ = [
    "MetricsRegistry",
    "NULL_TRACER",
    "NullTracer",
    "Tracer",
    "achieved_overlap_fraction",
]
