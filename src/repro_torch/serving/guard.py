"""FleetGuard: supervised recovery for the multi-tenant serving fleet.

Port of ``repro.serving.guard``. The finite-state sentinel is a
``torch.isfinite(...).all(...)`` reduce per tenant slot over each
cohort's stacked tables, never over their scratch row (which takes every
cohort's losers and padding writes), and every cohort's flags come back
in one host read a checked round.

``SessionManager`` gives a sick tenant exactly one cheap isolation
primitive — quarantine, which idle-masks its lane slot (all-
``valid=False`` batches, the established bitwise no-op) with zero
relayouts and zero effect on cohort-mates. This module is the
supervisor that decides WHEN to pull that lever and how to come back
from it:

detection (per round, after the launch is dispatched)
    * finite-state sentinel — a few reductions per cohort
      (``all(isfinite(...))`` per slot, a per-tenant bool vector) catch
      NaN/Inf-poisoned resident state. Reading them is the guard's ONE
      host sync; ``check_every > 1`` samples the check to preserve the
      async round pipeline between checks.
    * SLO-burn threshold — with an armed ``obs.SLOTracker`` and
      ``quarantine_slo_burn > 0``, a tenant whose burn rate crosses the
      threshold is quarantined (its error budget is being torched).
    * round watchdog — ``watchdog_s > 0`` flags rounds whose wall (on
      the guard's injected clock) exceeds the bound
      (``guard.watchdog_trips``; a ``watchdog`` span when traced).

recovery
    * quarantine -> auto-restore: after a deterministic capped
      exponential backoff (``backoff_s`` doubling to ``backoff_cap_s``
      on the injected clock) the guard reloads the tenant's state IN
      PLACE from its newest VALID snapshot (``cluster.
      restore_tenant_state`` -> ``checkpoint.restore_valid``: corrupt
      steps are skipped with a warning), joining the tenant's in-flight
      background write first. A restore only counts when the reloaded
      state passes the finite sentinel; otherwise the next attempt backs
      off further, and after ``max_restores`` failed attempts the tenant
      is permanently EVICTED (detached; ``guard.evictions``).
    * kernel-tier degradation: a classified launch failure
      (``faults.KernelFault``, carrying the lane's tenant) degrades the
      whole cohort one tier down the ladder fused -> staged -> ref and
      retries the SAME round. Cohorts are keyed by tier, so this is a
      lane MOVE (states carried over bitwise, one relayout), not a fork;
      at ``ref`` there is nowhere left to go and the fault re-raises.
      Only ``KernelFault`` degrades (an armed fault plan raises it): a
      real CUDA error or a failed kernel build propagates out of
      ``step`` with the tier unchanged.

Every quarantined round burns the tenant's SLO error budget
(``SLOTracker.violation`` — an outage observation with no latency
sample), counters land in the fleet ``MetricsRegistry``
(``guard.quarantines`` / ``guard.restores`` / ``guard.degradations`` /
``guard.evictions`` / ``guard.watchdog_trips`` and the
``guard.quarantined_now`` gauge), and recovery events emit ``cat=
"guard"`` spans into the round tracer when one is armed. The bitwise
contract: survivors of a quarantine round replay identically to a fleet
that never had the sick tenant attached (``launch/chaos_smoke.py`` pins
it).

The guard attaches itself as ``mgr.guard`` at construction;
``SessionManager.guarded_step`` (and through it ``run`` and the
frontend's pump) then routes every round through ``step`` here.
"""
from __future__ import annotations

import time

import torch

from repro_torch.serving.faults import KernelFault

#: the degradation ladder: each classified launch failure moves the
#: failing cohort one tier down; ``ref`` (torch ops) has no fallback.
DEGRADE_LADDER = {"fused": "staged", "staged": "ref"}


class FleetGuard:
    """Per-round health supervisor over a ``SessionManager`` fleet
    (see module docstring for the detection/recovery model).

    ::

        guard = FleetGuard(mgr, snapshot_root="/ckpt/fleet",
                           writer=writer, clock=clock,
                           max_restores=3, backoff_s=1.0)
        mgr.run(streams)        # rounds now route through guard.step

    ``clock`` must be the same injected clock the fault plan / tracer /
    frontend use — backoff schedules and watchdog walls are measured on
    it, which is what makes chaos runs deterministic.
    """

    def __init__(self, mgr, *, snapshot_root: str | None = None,
                 writer=None, clock=time.monotonic, max_restores: int = 3,
                 backoff_s: float = 1.0, backoff_cap_s: float = 30.0,
                 quarantine_slo_burn: float = 0.0, watchdog_s: float = 0.0,
                 check_every: int = 1, degrade_after: int = 1,
                 journal=None):
        if max_restores < 1:
            raise ValueError(f"max_restores must be >= 1, got "
                             f"{max_restores}")
        if backoff_s <= 0 or backoff_cap_s < backoff_s:
            raise ValueError("need 0 < backoff_s <= backoff_cap_s, got "
                             f"{backoff_s}/{backoff_cap_s}")
        if check_every < 1 or degrade_after < 1:
            raise ValueError("check_every and degrade_after must be >= 1")
        self.mgr = mgr
        #: snapshot root (``cluster.TenantSnapshotWriter`` layout) auto-
        #: restores reload from; None = no state reload, recovery only
        #: succeeds if the tenant's CURRENT state passes the sentinel.
        self.snapshot_root = snapshot_root
        #: the fleet's background snapshot writer (joined per tenant
        #: before a restore so the newest write is committed) or None.
        self.writer = writer
        #: the fleet's ``EventJournal`` (serving/journal.py) or None.
        #: Armed, an auto-restore is LOSSLESS: after the snapshot state
        #: reloads, the journal suffix past its cursor replays through
        #: the normal step pipeline, so the tenant resumes bitwise
        #: where it left off — post-snapshot events included.
        self.journal = journal
        self.clock = clock
        self.max_restores = int(max_restores)
        self.backoff_s = float(backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.quarantine_slo_burn = float(quarantine_slo_burn)
        self.watchdog_s = float(watchdog_s)
        self.check_every = int(check_every)
        self.degrade_after = int(degrade_after)
        self.obs = mgr.obs
        # counters (mirrored into the fleet registry under ``guard.``)
        self.quarantines = 0
        self.restores = 0
        self.degradations = 0
        self.evictions = 0
        self.watchdog_trips = 0
        self._rounds = 0
        #: per-tenant recovery ledger: ``{tid: {quarantines, restores,
        #: attempts, attempt_times, backoff_s, next_attempt_t, evicted,
        #: last_reason}}`` — survives eviction (the post-mortem record).
        self._t: dict[str, dict] = {}
        #: consecutive classified launch failures per cohort key.
        self._launch_failures: dict[tuple, int] = {}
        mgr.guard = self

    # ------------------------------------------------------------ round
    def step(self, batches) -> dict:
        """One supervised round: dispatch through ``SessionManager.step``
        (catching classified launch failures -> tier degradation + retry
        of the SAME round), then run the health checks, charge
        quarantined tenants' SLO burn, and attempt any backoff-due
        restores. Returns the round's ``{tid: BatchOut}``."""
        mgr = self.mgr
        t0 = self.clock()
        try:
            outs = mgr.step(batches)
        except KernelFault as e:
            outs = self._on_kernel_fault(e, batches)
        wall = self.clock() - t0
        self._rounds += 1
        if self.watchdog_s and wall > self.watchdog_s:
            self.watchdog_trips += 1
            self.obs.counter("guard.watchdog_trips").inc()
            self._span("watchdog", t0, wall_s=wall)
        if self._rounds % self.check_every == 0:
            self._health_check()
        self._slo_check()
        self._charge_outage()
        self._recover_due()
        return outs

    # ------------------------------------------------------- detection
    def _health_check(self) -> None:
        """Finite-state sentinel over every cohort; quarantines tenants
        whose resident state went NaN/Inf. Every cohort's flags are read
        back together: the guard's one host sync per checked round."""
        mgr = self.mgr
        cohorts = [c for c in mgr._cohorts.values() if c.tids]
        if not cohorts:
            return
        ok = torch.cat([c.finite_slots() for c in cohorts]).tolist()
        lo = 0
        for cohort in cohorts:
            for i, tid in enumerate(cohort.tids):
                if not ok[lo + i] and not mgr.is_quarantined(tid):
                    self.quarantine(tid, reason="nonfinite_state")
            lo += cohort.capacity

    def _slo_check(self) -> None:
        mgr = self.mgr
        if self.quarantine_slo_burn <= 0 or mgr.slo is None:
            return
        for tid in mgr.tenants:
            if mgr.is_quarantined(tid):
                continue
            burn = mgr.slo.tenant(tid)["burn_rate"]
            if burn > self.quarantine_slo_burn:
                self.quarantine(tid, reason="slo_burn")

    def _charge_outage(self) -> None:
        """Every round a tenant sits quarantined is an outage violation:
        burn its SLO error budget even though no latency was observed."""
        mgr = self.mgr
        if mgr.slo is None:
            return
        for tid in mgr.quarantined:
            mgr.slo.violation(tid)

    # ------------------------------------------------------ quarantine
    def quarantine(self, tid: str, reason: str = "manual") -> None:
        """Idle-mask ``tid``'s lane (``SessionManager.quarantine``) and
        schedule its first restore attempt one backoff from now."""
        t0 = self.clock()
        self.mgr.quarantine(tid)
        rec = self._rec(tid)
        rec["quarantines"] += 1
        rec["last_reason"] = reason
        rec["attempts"] = 0
        rec["attempt_times"] = []
        rec["backoff_s"] = self.backoff_s
        rec["next_attempt_t"] = t0 + self.backoff_s
        self.quarantines += 1
        self.obs.counter("guard.quarantines").inc()
        self._span("quarantine", t0, tenant=tid, reason=reason)

    def _rec(self, tid: str) -> dict:
        rec = self._t.get(tid)
        if rec is None:
            rec = self._t[tid] = {
                "quarantines": 0, "restores": 0, "attempts": 0,
                "attempt_times": [], "backoff_s": self.backoff_s,
                "next_attempt_t": 0.0, "evicted": False,
                "last_reason": None}
        return rec

    # --------------------------------------------------------- restore
    def _recover_due(self) -> None:
        for tid in sorted(self.mgr.quarantined):
            rec = self._t.get(tid)
            if rec is None or rec["evicted"]:
                continue
            if self.clock() >= rec["next_attempt_t"]:
                self._attempt_restore(tid, rec)

    def _attempt_restore(self, tid: str, rec: dict) -> None:
        """One restore attempt: join the tenant's in-flight snapshot
        write, reload its newest VALID snapshot in place (when a root is
        configured), replay the journal suffix past that snapshot's
        cursor (when a journal is armed — the lossless half), and count
        success only if the resulting state passes the finite sentinel.
        Failure backs off exponentially (capped); ``max_restores``
        failures evict permanently."""
        from repro_torch.distributed import checkpoint as ckpt

        mgr = self.mgr
        t0 = self.clock()
        rec["attempts"] += 1
        rec["attempt_times"].append(t0)
        err, healthy, replayed = None, False, 0
        try:
            if self.snapshot_root is not None:
                if self.writer is not None:
                    try:
                        self.writer.join(tid)
                    except Exception as e:  # a failed write: older steps
                        err = e             # may still restore below
                from repro_torch.serving import cluster
                used = cluster.restore_tenant_state(
                    mgr, self.snapshot_root, tid)
                if self.journal is not None:
                    # lossless resume: replay every journaled flush past
                    # the RESTORED step's cursor through the normal step
                    # pipeline (mgr.step, not guarded_step — no guard
                    # recursion). The lane must serve during replay, so
                    # the quarantine lifts for it and re-arms after; the
                    # sentinel below decides whether it stays lifted.
                    cur = cluster.snapshot_meta(
                        self.snapshot_root, tid, step=used).get("journal")
                    if cur is not None:
                        mgr.unquarantine(tid)
                        try:
                            res = self.journal.replay(tid, cur, mgr.step)
                        finally:
                            mgr.quarantine(tid)
                        replayed = res.rounds
            healthy = self._tenant_healthy(tid)
        except (FileNotFoundError, *ckpt.CORRUPTION_ERRORS) as e:
            err = e
        if healthy:
            mgr.unquarantine(tid)
            rec["restores"] += 1
            self.restores += 1
            self.obs.counter("guard.restores").inc()
            self._span("restore", t0, tenant=tid,
                       attempts=rec["attempts"], replayed=replayed)
            return
        if rec["attempts"] >= self.max_restores:
            self._evict(tid, rec, err)
            return
        rec["backoff_s"] = min(rec["backoff_s"] * 2, self.backoff_cap_s)
        rec["next_attempt_t"] = self.clock() + rec["backoff_s"]

    def _evict(self, tid: str, rec: dict, err) -> None:
        """Permanent eviction: the recovery ceiling is exhausted, detach
        the tenant (its lane slot frees/idles per the reserve policy)."""
        t0 = self.clock()
        rec["evicted"] = True
        rec["last_reason"] = (f"evicted after {rec['attempts']} failed "
                              f"restores"
                              + (f" ({err})" if err is not None else ""))
        self.mgr.remove_tenant(tid)
        self.evictions += 1
        self.obs.counter("guard.evictions").inc()
        self._span("evict", t0, tenant=tid, attempts=rec["attempts"])

    def _tenant_healthy(self, tid: str) -> bool:
        cohort = self.mgr.cohort_of(tid)
        return bool(cohort.finite_slots()[cohort.tids.index(tid)])

    # ----------------------------------------------------- degradation
    def _cohort_key(self, cohort) -> tuple:
        from repro_torch.core import pipeline as pl
        return (pl.variant_name(cohort.cfg), cohort.tier, cohort.param_set)

    def _on_kernel_fault(self, e: KernelFault, batches) -> dict:
        """A classified launch failure: count it against the failing
        cohort, degrade the cohort's kernel tier once the count reaches
        ``degrade_after``, and retry the SAME round (the injector rolled
        its round cursor back, so the retry replays the same logical
        round and already-fired faults stay fired)."""
        mgr = self.mgr
        cohort = mgr.cohort_of(e.tid)
        key = self._cohort_key(cohort)
        n = self._launch_failures.get(key, 0) + 1
        self._launch_failures[key] = n
        if n >= self.degrade_after:
            self._launch_failures.pop(key, None)
            self._degrade(cohort, because=e)
        return mgr.step(batches)

    def _degrade(self, cohort, because=None) -> None:
        """Move every tenant of ``cohort`` one tier down the ladder.

        A lane move, not a fork: cohorts are keyed by (cfg, tier,
        param set), so re-admitting the tenants at the lower tier lands
        them in the (possibly pre-existing) lower lane with their
        states, serving counters, and quarantine flags carried over —
        exactly ONE relayout of the coalesced round."""
        from repro_torch.core import pipeline as pl

        mgr = self.mgr
        nxt = DEGRADE_LADDER.get(cohort.tier)
        if nxt is None:
            if because is not None:
                raise because
            raise RuntimeError(f"cohort {pl.variant_name(cohort.cfg)!r} is "
                               "already at the 'ref' tier; no fallback "
                               "left")
        t0 = self.clock()
        variant = pl.variant_name(cohort.cfg)
        tau = cohort.cfg.reservoir_tau
        pname = cohort.param_set
        moved = list(cohort.tids)
        mgr.sync()
        states = {t: mgr.state_of(t) for t in moved}
        stats = {t: dict(mgr._tenant_stats.get(t) or {}) for t in moved}
        quarantined = [t for t in moved if mgr.is_quarantined(t)]
        for t in moved:
            mgr.remove_tenant(t)
        for t in moved:
            mgr.add_tenant(variant, name=t, reservoir_tau=tau,
                           use_kernels=nxt, params=pname)
            mgr.set_state(t, states[t])
            if stats[t]:
                mgr._tenant_stats[t] = stats[t]
        for t in quarantined:
            mgr.quarantine(t)
        self.degradations += 1
        self.obs.counter("guard.degradations").inc()
        self._span("degrade", t0, variant=variant, tier=nxt,
                   tenants=len(moved))

    # --------------------------------------------------------- reading
    def _span(self, name: str, t0: float, **args) -> None:
        """Emit a recovery span (``cat="guard"``) when a tracer is
        armed. Recovery events are rare, so they record on EVERY round,
        not only sampled ones — the outage window must never be
        invisible in a trace."""
        tr = getattr(self.mgr, "tracer", None)
        if tr is not None:
            tr.add(name, t0, tr.clock(), cat="guard", **args)

    def tenant_view(self, tid: str) -> dict:
        """The tenant's recovery record for ``tenant_stats()``:
        quarantine/restore tallies, pending-attempt countdown, eviction
        flag, and the last quarantine reason."""
        rec = self._t.get(tid)
        quarantined = (tid in getattr(self.mgr, "quarantined", ()))
        if rec is None:
            return {"quarantined": quarantined, "quarantines": 0,
                    "restores": 0, "evicted": False, "last_reason": None,
                    "next_attempt_in_s": None}
        nxt = (max(0.0, rec["next_attempt_t"] - self.clock())
               if quarantined and not rec["evicted"] else None)
        return {"quarantined": quarantined,
                "quarantines": rec["quarantines"],
                "restores": rec["restores"],
                "restore_attempts": rec["attempts"],
                "evicted": rec["evicted"],
                "last_reason": rec["last_reason"],
                "next_attempt_in_s": nxt}

    def snapshot(self) -> dict:
        """The fleet-level recovery view a metrics response embeds —
        counters plus the live quarantine set and eviction post-mortems."""
        return {"quarantines": self.quarantines,
                "restores": self.restores,
                "degradations": self.degradations,
                "evictions": self.evictions,
                "watchdog_trips": self.watchdog_trips,
                "quarantined_now": sorted(self.mgr.quarantined),
                "evicted": sorted(t for t, r in self._t.items()
                                  if r["evicted"])}
