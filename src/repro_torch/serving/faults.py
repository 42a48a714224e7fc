"""Deterministic fault injection for the serving stack.

Port of ``repro.serving.faults``. A ``nan_state`` fault writes
``torch.full_like`` NaN memory through ``SessionManager.set_state``, on
the tenant's device.

Fault tolerance is only testable if faults are REPRODUCIBLE: a chaos run
must fire the same faults at the same rounds every time, so the guard's
recovery (``serving/guard.py``) can be pinned bitwise against an
undisturbed fleet. This module is the injection side of that contract:

``Fault``
    one planned fault, keyed by kind + tenant + position (``at``/
    ``count``). Positions are logical — round indices for round-scoped
    kinds, per-tenant event/write ordinals for ingest and snapshot
    kinds — never wall clock, so a plan replays identically regardless
    of host speed.

``FaultInjector``
    the armed plan. The serving layers call its hooks from
    zero-cost-gated sites (``if self._faults is not None: ...``), so a
    fleet that
    never arms an injector pays one attribute test per round and
    nothing else. Every fault that fires lands in the ``fired`` ledger;
    ``pending()`` lists what has not, which is how a chaos run
    asserts the whole plan was detected.

Fault taxonomy (``KINDS``; docs/ROBUSTNESS.md):

* ``nan_state``    — corrupt a tenant's resident memory table to NaN at
  round ``at`` (a poisoned-state upset: the guard's finite-state
  sentinel must catch it).
* ``poison_batch`` — overwrite a tenant's submitted batch timestamps
  with NaN at round ``at`` (corruption past ingest validation).
* ``poison_event`` — corrupt the timestamp of the tenant's ``at``-th
  accepted ingest event (wire-level corruption; the frontend's
  validation must reject it before it reaches a queue).
* ``kernel_fail``  — raise ``KernelFault`` before the round launch at
  round ``at`` (a lowering/launch failure; the guard degrades the
  cohort's kernel tier).
* ``snapshot_io``  — raise ``SnapshotIOFault`` on the tenant's
  ``at``-th..``at+count-1``-th background snapshot write ATTEMPT
  (retries count as attempts, so ``count=1`` tests the writer's retry
  path and ``count > retries`` its failure path).
* ``stall``        — advance the injected clock by ``delay_s`` at round
  ``at`` (a stuck round; the guard's watchdog must flag it).
* ``journal_io``   — raise ``JournalIOFault`` on the tenant's
  ``at``-th..``at+count-1``-th journal append (a WAL write error; the
  frontend must REJECT the ingest — an event that is not on disk was
  never accepted, so the client's retry is safe).
* ``torn_write``   — make the tenant's ``at``-th journal append write a
  PARTIAL record and wedge the log (a crash mid-append; reopen must
  truncate the torn tail, never fabricate the record).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

#: every fault kind a plan may contain (see module docstring).
KINDS = ("nan_state", "poison_batch", "poison_event", "kernel_fail",
         "snapshot_io", "stall", "journal_io", "torn_write")

#: kinds keyed by the injector's round cursor.
_ROUND_KINDS = ("nan_state", "poison_batch", "kernel_fail", "stall")


def _nan_like(ts):
    """NaN timestamps of ``ts``'s shape, where ``ts`` lives (host numpy
    columns stay on the host)."""
    if isinstance(ts, torch.Tensor):
        return torch.full_like(ts, float("nan"), dtype=torch.float32)
    return np.full_like(np.asarray(ts), np.nan, dtype=np.float32)


class KernelFault(RuntimeError):
    """An injected (or classified) kernel-launch failure.

    Carries the tenant whose lane the failure is attributed to, so the
    guard can find the cohort to degrade."""

    def __init__(self, tid: str, detail: str = "injected launch failure"):
        super().__init__(f"kernel launch failed on tenant {tid!r} lane: "
                         f"{detail}")
        self.tid = tid


class SnapshotIOFault(OSError):
    """An injected snapshot-write IO error."""


class JournalIOFault(OSError):
    """An injected journal-append IO error."""


class FakeClock:
    """A callable, manually advanced clock — the injected time source of
    deterministic chaos runs and guard tests (``clock()`` reads,
    ``clock.advance(s)`` moves)."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, s: float) -> float:
        self.t += float(s)
        return self.t


@dataclass
class Fault:
    """One planned fault. ``at`` is a logical position (round index or
    per-tenant ordinal — see module docstring); the fault is active for
    positions ``at <= p < at + count``. ``fired`` counts activations."""
    kind: str
    tenant: str | None = None
    at: int = 0
    count: int = 1
    delay_s: float = 0.0
    fired: int = field(default=0, compare=False)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {KINDS}")
        if self.kind in ("nan_state", "poison_batch", "poison_event",
                         "snapshot_io", "kernel_fail", "journal_io",
                         "torn_write") \
                and self.tenant is None:
            raise ValueError(f"fault kind {self.kind!r} needs tenant=")

    def _active(self, pos: int) -> bool:
        return self.at <= pos < self.at + self.count


class FaultInjector:
    """An armed fault plan (see module docstring).

    Hooks — each called from a ``fault``-gated site in exactly one
    layer, all deterministic in logical positions:

    * ``on_round(mgr, batches)``   — ``SessionManager.step`` entry
      (advances the round cursor; applies stalls, state poison, batch
      poison; returns the possibly-corrupted batches).
    * ``before_launch(mgr)``       — just before the round's
      launch dispatch; raises ``KernelFault``.
    * ``on_ingest(tid, *event)``   — ``ServingFrontend.submit`` before
      validation; returns the possibly-corrupted event tuple.
    * ``on_snapshot_write(tid)``   — ``TenantSnapshotWriter`` worker
      thread, once per write attempt; raises ``SnapshotIOFault``.
    * ``on_journal_append(tid)``   — ``ServingFrontend.submit`` before
      the journal write; raises ``JournalIOFault`` or returns
      ``"torn"`` to make the append itself tear.
    """

    def __init__(self, faults, clock: FakeClock | None = None):
        self.faults = list(faults)
        for f in self.faults:
            if not isinstance(f, Fault):
                raise TypeError(f"fault plan entries must be Fault, "
                                f"got {f!r}")
            if f.kind == "stall" and clock is None:
                raise ValueError("a 'stall' fault needs an advanceable "
                                 "clock (FaultInjector(..., clock=...))")
        self.clock = clock
        self.round_idx = -1          # on_round increments first
        #: ledger of every activation: ``{kind, tenant, round, pos}`` —
        #: the chaos run's "every planned fault was detected" proof.
        self.fired: list[dict] = []
        self._event_idx: dict[str, int] = {}
        self._write_idx: dict[str, int] = {}
        self._journal_idx: dict[str, int] = {}

    def _fire(self, f: Fault, pos: int) -> None:
        f.fired += 1
        self.fired.append({"kind": f.kind, "tenant": f.tenant,
                           "round": self.round_idx, "pos": pos})

    def pending(self) -> list:
        """Planned faults that have not fully fired yet."""
        return [f for f in self.faults if f.fired < f.count]

    # ---------------------------------------------------------- hooks
    def on_round(self, mgr, batches):
        """Round-entry hook: advance the round cursor, apply round-scoped
        faults. Returns the (possibly replaced) batches mapping."""
        self.round_idx += 1
        out = batches
        for f in self.faults:
            if f.kind not in _ROUND_KINDS or f.kind == "kernel_fail" \
                    or not f._active(self.round_idx) \
                    or f.fired >= f.count:
                continue
            if f.kind == "stall":
                self.clock.advance(f.delay_s)
                self._fire(f, self.round_idx)
            elif f.kind == "nan_state":
                if f.tenant in mgr.tenants:
                    st = mgr.state_of(f.tenant)
                    mgr.set_state(f.tenant, st._replace(
                        memory=torch.full_like(st.memory, float("nan"))))
                    self._fire(f, self.round_idx)
            elif f.kind == "poison_batch":
                if f.tenant in out:
                    if out is batches:
                        out = dict(batches)   # never mutate the caller's
                    b = out[f.tenant]
                    cols = (b if isinstance(b, tuple) and not hasattr(
                        b, "_replace") else None)
                    if cols is not None:
                        src, dst, eid, ts, valid = cols[:5]
                        out[f.tenant] = (src, dst, eid, _nan_like(ts),
                                         valid)
                    else:
                        out[f.tenant] = b._replace(ts=_nan_like(b.ts))
                    self._fire(f, self.round_idx)
        return out

    def before_launch(self, mgr) -> None:
        """Pre-dispatch hook: raise the round's planned launch failure.

        The failed dispatch never completes a round, so the round cursor
        is rolled back one — the guard's retry of the SAME batches
        replays the same logical round index (and the fired-count guard
        keeps already-fired faults from firing again on the retry)."""
        for f in self.faults:
            if f.kind == "kernel_fail" and f._active(self.round_idx) \
                    and f.fired < f.count and f.tenant in mgr.tenants:
                self._fire(f, self.round_idx)
                self.round_idx -= 1
                raise KernelFault(f.tenant)

    def on_ingest(self, tid: str, src, dst, eid, ts, neg_dst):
        """Ingest hook: corrupt the tenant's ``at``-th submitted event.

        Runs BEFORE the frontend's field validation so an injected
        non-finite timestamp exercises the same rejection path a
        corrupted wire payload would.
        """
        pos = self._event_idx.get(tid, 0)
        self._event_idx[tid] = pos + 1
        for f in self.faults:
            if f.kind == "poison_event" and f.tenant == tid \
                    and f._active(pos):
                self._fire(f, pos)
                return src, dst, eid, float("nan"), neg_dst
        return src, dst, eid, ts, neg_dst

    def on_snapshot_write(self, tid: str) -> None:
        """Snapshot-write hook (worker thread): fail the tenant's
        ``at``-th..``at+count-1``-th write attempt."""
        pos = self._write_idx.get(tid, 0)
        self._write_idx[tid] = pos + 1
        for f in self.faults:
            if f.kind == "snapshot_io" and f.tenant == tid \
                    and f._active(pos):
                self._fire(f, pos)
                raise SnapshotIOFault(
                    f"injected snapshot IO error for tenant {tid!r} "
                    f"(write attempt {pos})")

    def on_journal_append(self, tid: str) -> str | None:
        """Journal-append hook: fail or tear the tenant's ``at``-th..
        ``at+count-1``-th WAL append. Returns ``"torn"`` when the
        append should write a partial record (and wedge the log), else
        ``None``; raises ``JournalIOFault`` for a clean IO failure."""
        pos = self._journal_idx.get(tid, 0)
        self._journal_idx[tid] = pos + 1
        for f in self.faults:
            if f.tenant != tid or not f._active(pos):
                continue
            if f.kind == "journal_io" and f.fired < f.count:
                self._fire(f, pos)
                raise JournalIOFault(
                    f"injected journal IO error for tenant {tid!r} "
                    f"(append {pos})")
            if f.kind == "torn_write" and f.fired < f.count:
                self._fire(f, pos)
                return "torn"
        return None
