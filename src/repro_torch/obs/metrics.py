"""Typed metrics with bounded memory: counters, gauges, histograms.

The port's own copy of ``repro.obs.metrics`` (which imports only ``math``
and ``threading``), so that the port's summaries compute their keys exactly
as the reference's do. Three metric types:

``Counter``
    monotonic accumulator (``inc``); resets only explicitly.
``Gauge``
    last-write-wins point-in-time value (``set``).
``Histogram``
    streaming distribution over FIXED log-spaced buckets —
    ``PER_DECADE`` buckets per decade between ``LO`` and ``HI`` plus
    underflow/overflow, so memory is bounded no matter how many samples
    stream through, and two histograms with the same geometry merge by
    adding bucket counts (cross-shard / cross-run aggregation). Exact
    ``count``/``sum``/``min``/``max`` ride along; quantiles come from
    the cumulative bucket counts at the geometric bucket midpoint,
    clamped to the observed ``[min, max]`` — exact for constant samples,
    within one bucket ratio (``10 ** (1 / PER_DECADE)``, ~7.5%)
    otherwise. The empty-sample case is DEFINED: ``quantile``/``mean``
    return ``None`` instead of making every caller pre-check.

``MetricsRegistry.snapshot()`` walks every metric under one lock, so a
single stats/metrics response is internally consistent.
"""
from __future__ import annotations

import math
import threading


class Counter:
    """Monotonic counter. ``inc`` only; negative increments are an error
    (a decreasing "counter" is a gauge)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str = ""):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r}: negative increment "
                             f"{n}; use a Gauge for values that go down")
        self.value += n

    def reset(self) -> None:
        self.value = 0

    def snapshot(self):
        return self.value


class Gauge:
    """Last-write-wins point-in-time value (queue depth, current traces)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str = ""):
        self.name = name
        self.value = 0

    def set(self, v) -> None:
        self.value = v

    def reset(self) -> None:
        self.value = 0

    def snapshot(self):
        return self.value


class Histogram:
    """Streaming histogram over fixed log-spaced buckets (see module
    docstring). Records are O(1); memory is a fixed ~350-int array."""

    #: bucket geometry — class-level so every histogram in the fleet
    #: shares it and any two can merge. [1e-7 s, 1e4 s] covers ns-scale
    #: span durations through hours-long drains.
    LO = 1e-7
    HI = 1e4
    PER_DECADE = 32

    __slots__ = ("name", "counts", "count", "total", "vmin", "vmax", "_n")

    def __init__(self, name: str = ""):
        self.name = name
        self._n = round(math.log10(self.HI / self.LO)) * self.PER_DECADE
        self.reset()

    def reset(self) -> None:
        self.counts = [0] * (self._n + 2)   # [under] + buckets + [over]
        self.count = 0
        self.total = 0.0
        self.vmin = None
        self.vmax = None

    def _index(self, x: float) -> int:
        if x <= self.LO:
            return 0
        if x >= self.HI:
            return self._n + 1
        return 1 + min(self._n - 1,
                       int(math.log10(x / self.LO) * self.PER_DECADE))

    def _bucket_value(self, i: int) -> float:
        if i == 0:
            return self.LO
        if i == self._n + 1:
            return self.HI
        lo = self.LO * 10 ** ((i - 1) / self.PER_DECADE)
        hi = self.LO * 10 ** (i / self.PER_DECADE)
        return math.sqrt(lo * hi)           # geometric bucket midpoint

    def record(self, x, n: int = 1) -> None:
        x = float(x)
        self.counts[self._index(x)] += n
        self.count += n
        self.total += x * n
        self.vmin = x if self.vmin is None else min(self.vmin, x)
        self.vmax = x if self.vmax is None else max(self.vmax, x)

    def mean(self):
        return self.total / self.count if self.count else None

    def quantile(self, q: float):
        """The q-quantile (0..1) or ``None`` when empty. Same rank
        convention as the sorted-list ``lat[int(q * len)]`` it replaced."""
        if not self.count:
            return None
        rank = min(self.count - 1, int(q * self.count))
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc > rank:
                if i == 0:                  # underflow: best info is vmin
                    return self.vmin
                if i == self._n + 1:        # overflow: best info is vmax
                    return self.vmax
                v = self._bucket_value(i)
                return min(max(v, self.vmin), self.vmax)
        return self.vmax

    def merge(self, other: "Histogram") -> None:
        if other._n != self._n:
            raise ValueError("histograms with different bucket geometry "
                             "cannot merge")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        for v in (other.vmin, other.vmax):
            if v is not None:
                self.vmin = v if self.vmin is None else min(self.vmin, v)
                self.vmax = v if self.vmax is None else max(self.vmax, v)

    def snapshot(self) -> dict:
        return {"count": self.count, "sum": self.total, "mean": self.mean(),
                "min": self.vmin, "max": self.vmax,
                "p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p99": self.quantile(0.99)}


class MetricsRegistry:
    """Named metrics with get-or-create accessors and one atomic view.

    ::

        obs = MetricsRegistry()
        obs.counter("session.rounds").inc()
        obs.histogram("frontend.event_latency_s").record(0.003)
        obs.snapshot()          # one lock-consistent dict of everything

    A name is bound to ONE type for the registry's lifetime; asking for
    it as another type raises (silent shadowing would split a metric's
    history across two objects).
    """

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name)
            elif type(m) is not cls:
                raise TypeError(f"metric {name!r} is a {type(m).__name__}, "
                                f"requested as {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self) -> tuple:
        return tuple(sorted(self._metrics))

    def snapshot(self, prefix: str = "") -> dict:
        """``{name: value-or-histogram-dict}`` taken in ONE pass under
        the registry lock — every reader of a stats response sees the
        same instant (the frontend/admission consistency contract)."""
        with self._lock:
            return {name: m.snapshot()
                    for name, m in sorted(self._metrics.items())
                    if name.startswith(prefix)}

    def merge(self, other: "MetricsRegistry") -> None:
        """Fold another registry in (cross-shard aggregation): counters
        add, gauges take the other's value, histograms merge buckets."""
        for name in other.names():
            m = other.get(name)
            if isinstance(m, Counter):
                self.counter(name).inc(m.value)
            elif isinstance(m, Gauge):
                self.gauge(name).set(m.value)
            else:
                self.histogram(name).merge(m)
