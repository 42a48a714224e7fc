"""Metrics for the port's serving summaries: a copy of the reference's
``repro.obs.metrics`` (counters, gauges, log-bucketed histograms)."""
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]
