"""Live tenant admission: capacity classes for a cohort's tenant slots.

Port of ``repro.serving.admission``. A coalesced round's layout (which
cohort owns which rows of the super-batch) is built once and kept while
the fleet's shape holds. Laying a cohort out with spare, idle-masked
slots lets a tenant attach into one and another detach from one without
a relayout; only an exhausted class relays out.

``CapacityLadder`` is the session's ``reserve=`` policy;
``AdmissionController`` wraps ``add_tenant`` / ``remove_tenant`` /
``prewarm_cohort`` and records, per admission, whether it landed in a
spare slot (fast) or relaid the round out.
"""
from __future__ import annotations

from dataclasses import dataclass


class CapacityLadder:
    """``capacity_for(n)``: the tenant slots to lay out for ``n`` resident
    tenants, the smallest class holding ``n + headroom``, so right after a
    relayout at least ``headroom`` spare slots remain. Past the top of
    ``classes`` the classes keep doubling.

    The default ladder (2, 4, 8, ..., 64; headroom 1) relays a
    single-cohort fleet out at sizes 2->3, 4->5, 8->9, ...: O(log n)
    relayouts over a ramp, with idle slots under 2x.
    """

    def __init__(self, classes: tuple = (2, 4, 8, 16, 32, 64),
                 headroom: int = 1):
        if not classes or list(classes) != sorted(set(classes)):
            raise ValueError("classes must be strictly increasing")
        if headroom < 1:
            raise ValueError("headroom must be >= 1 (zero headroom means "
                             "every attach relays out — that is the "
                             "reserve=None behavior)")
        self.classes = tuple(int(c) for c in classes)
        self.headroom = int(headroom)

    def capacity_for(self, n_tenants: int) -> int:
        """Smallest class with room for ``n_tenants`` plus headroom."""
        need = max(n_tenants + self.headroom, self.classes[0])
        for c in self.classes:
            if c >= need:
                return c
        c = self.classes[-1]
        while c < need:        # geometric growth past the ladder top
            c *= 2
        return c

    def __repr__(self) -> str:
        return (f"CapacityLadder(classes={self.classes}, "
                f"headroom={self.headroom})")


@dataclass(frozen=True)
class Admission:
    """One audited attach/detach/prewarm outcome."""
    tid: str | None       #: tenant id (None for prewarm)
    action: str           #: "attach" | "detach" | "prewarm"
    fast: bool            #: True = landed in the compiled program as-is
    relayout: bool        #: True = coalesced layout rebuilt (slow path)
    new_cohort: bool      #: True = a new variant lane was created
    size: int             #: cohort tenants AFTER the admission
    capacity: int         #: cohort stacked rows AFTER the admission


class AdmissionController:
    """Audited live admission over a reserve-enabled ``SessionManager``.

    ::

        mgr = SessionManager(params, ef, model=cfg, reserve=True)
        adm = AdmissionController(mgr)
        adm.prewarm("np4")              # lane compiled before tenant 1
        tid = adm.attach("np4")         # fast path: in-place slot write
        adm.detach(tid)                 # fast path: swap-remove, slot idles
        adm.log[-1].fast                # -> True
    """

    def __init__(self, mgr):
        if getattr(mgr, "reserve", None) is None:
            raise ValueError(
                "AdmissionController needs a reserve-enabled manager "
                "(SessionManager(..., reserve=True) or an explicit "
                "CapacityLadder); without spare lane slots every "
                "admission is a relayout")
        self.mgr = mgr
        #: chronological ``Admission`` records, newest last.
        self.log: list[Admission] = []

    def _record(self, tid, action) -> Admission:
        last = self.mgr.last_admission or {}
        cohort = self.mgr._tenant_cohort.get(tid)
        size = cohort.size if cohort is not None else 0
        cap = cohort.capacity if cohort is not None else 0
        adm = Admission(tid=tid, action=action,
                        fast=not (last.get("relayout")
                                  or last.get("new_cohort")),
                        relayout=bool(last.get("relayout")),
                        new_cohort=bool(last.get("new_cohort")),
                        size=size, capacity=cap)
        self.log.append(adm)
        self.mgr.obs.counter(
            "admission.fast" if adm.fast else "admission.slow").inc()
        return adm

    def attach(self, variant=None, *, name: str | None = None,
               reservoir_tau: float | None = None,
               use_kernels=None, params: str | None = None) -> str:
        tid = self.mgr.add_tenant(variant, name=name,
                                  reservoir_tau=reservoir_tau,
                                  use_kernels=use_kernels, params=params)
        self._record(tid, "attach")
        return tid

    def detach(self, tid: str) -> Admission:
        self.mgr.remove_tenant(tid)
        return self._record(tid, "detach")

    def prewarm(self, variant=None, *,
                reservoir_tau: float | None = None,
                use_kernels=None, params: str | None = None) -> None:
        """Materialize a variant lane at reserve capacity with zero
        tenants, so its first tenant attaches fast-path."""
        self.mgr.prewarm_cohort(variant, reservoir_tau=reservoir_tau,
                                use_kernels=use_kernels, params=params)
        self.log.append(Admission(tid=None, action="prewarm", fast=False,
                                  relayout=True, new_cohort=True,
                                  size=0, capacity=0))
        self.mgr.obs.counter("admission.slow").inc()

    def stats(self) -> dict:
        """Per-cohort occupancy plus the fast/slow admission tallies."""
        occupancy = [
            {"tenants": list(c.tids), "size": c.size,
             "capacity": c.capacity, "spare": c.spare}
            for c in self.mgr._cohorts.values()
        ]
        return {
            "cohorts": occupancy,
            "admissions": len(self.log),
            "fast": sum(1 for a in self.log if a.fast),
            "relayouts": sum(1 for a in self.log if a.relayout),
            # compile_counters is ONE registry snapshot now, so this view
            # and a frontend stats() in the same response always agree
            "compile": self.mgr.compile_counters(),
        }
