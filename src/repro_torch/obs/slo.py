"""Per-tenant latency SLOs: objective tracking + error-budget burn.

A copy of the reference's ``repro.obs.slo`` over the port's
``obs.metrics.Histogram``.

An SLO here is "``objective`` of a tenant's observations complete within
``target_ms``" (e.g. 99% under 25 ms). Per tenant the tracker keeps a
bounded ``obs.Histogram`` of the observed latencies plus exact event /
violation counts, and derives SRE-style burn accounting:

* ``error_rate``   — violations / events.
* ``burn_rate``    — error_rate / (1 - objective): how fast the error
  budget is being consumed relative to what the objective allows.
  1.0 means exactly on budget; > 1 the objective is being missed
  ("fast burn"); the window is the tracker's lifetime (one serving
  run), so cumulatively ``burn_rate`` IS the fraction of the run's
  budget consumed.
* ``budget_remaining`` — max(0, 1 - burn_rate) of the run's budget.

What a "latency observation" is depends on the deployment: the online
frontend observes per-EVENT queue->flush latency (``source="event"``);
an offline session run observes per-ROUND walls reconstructed from the
dispatch timestamps (``source="round"``, fed by ``summary()``). The
``source`` tag keeps the two from double-feeding one tracker.

``tenant(tid)`` always returns a full dict — zero-observation tenants
report ``events=0, burn_rate=0.0, observed_p99_ms=None`` rather than
being absent, so ``summary()["per_tenant"]`` carries SLO burn for EVERY
tenant (the acceptance criterion, and what the autotuner will poll).
"""
from __future__ import annotations

from repro_torch.obs.metrics import Histogram


class SLOTracker:
    """Latency-objective tracking per tenant (see module docstring)."""

    def __init__(self, target_ms: float, objective: float = 0.99,
                 source: str = "round"):
        if not target_ms > 0:
            raise ValueError(f"target_ms must be > 0, got {target_ms}")
        if not 0.0 < objective < 1.0:
            raise ValueError("objective must be in (0, 1) — 1.0 leaves "
                             f"zero error budget to burn; got {objective}")
        self.target_ms = float(target_ms)
        self.target_s = self.target_ms / 1e3
        self.objective = float(objective)
        #: what one observation is: "round" (summary-fed walls) or
        #: "event" (frontend-fed per-event latencies).
        self.source = source
        self._t: dict[str, dict] = {}

    def _slot(self, tid: str) -> dict:
        d = self._t.get(tid)
        if d is None:
            d = self._t[tid] = {"hist": Histogram(f"slo.{tid}.latency_s"),
                                "events": 0, "violations": 0}
        return d

    def observe(self, tid: str, latency_s: float, n: int = 1) -> None:
        d = self._slot(tid)
        d["hist"].record(latency_s, n)
        d["events"] += n
        if latency_s > self.target_s:
            d["violations"] += n

    def violation(self, tid: str, n: int = 1) -> None:
        """Record ``n`` outright violations WITHOUT a latency sample — an
        outage observation (e.g. the guard charging each round a tenant
        sits quarantined), where "how late" is unbounded/meaningless but
        the error budget must still burn. Counts into ``events`` too, so
        ``error_rate`` stays violations/events over everything observed."""
        d = self._slot(tid)
        d["events"] += n
        d["violations"] += n

    def tenant(self, tid: str) -> dict:
        """The tenant's SLO view (a full dict even before any
        observation — see module docstring)."""
        d = self._t.get(tid)
        events = d["events"] if d else 0
        violations = d["violations"] if d else 0
        p99 = d["hist"].quantile(0.99) if d else None
        err = violations / events if events else 0.0
        burn = err / (1.0 - self.objective)
        return {"target_ms": self.target_ms, "objective": self.objective,
                "source": self.source, "events": events,
                "violations": violations,
                "observed_p99_ms": None if p99 is None else p99 * 1e3,
                "error_rate": err, "burn_rate": burn,
                "budget_remaining": max(0.0, 1.0 - burn)}

    def snapshot(self) -> dict:
        return {tid: self.tenant(tid) for tid in sorted(self._t)}
