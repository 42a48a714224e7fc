"""Fleet observability of the port: metrics registry, round tracer, SLO
accounting. Copies of the reference's ``repro.obs`` modules:

``metrics``
    typed counters, gauges and streaming log-bucketed histograms behind
    one ``MetricsRegistry`` per fleet.

``trace``
    span-based round tracing on an injected clock, Chrome/Perfetto
    ``trace_event`` and JSON-lines export; sampled, so only a sampled
    round fences the device.

``slo``
    per-tenant latency-objective tracking: observed p99 against a target
    and the error budget's burn rate.
"""
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.slo import SLOTracker
from repro_torch.obs.trace import RoundTracer, Span

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "RoundTracer", "SLOTracker", "Span"]
