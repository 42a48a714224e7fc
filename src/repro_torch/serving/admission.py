"""Capacity classes for a cohort's tenant slots: the session's ``reserve=``
policy.

Port of ``repro.serving.admission.CapacityLadder``. A coalesced round's
layout (which cohort owns which rows of the super-batch) is built once
and kept while the fleet's shape holds. Laying a cohort out with spare,
idle-masked slots lets a tenant attach into one and another detach from
one without a relayout; only an exhausted class relays out.
"""
from __future__ import annotations


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
