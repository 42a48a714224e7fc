"""Hooks of the op-trace recorder (``launch/hlo_analysis.record``) in the
code it traces.

``ACTIVE.recorder`` is the recorder active on the calling thread, or None
(``record`` activates it on its own thread; a pinned function activates it
on the thread that runs it, an autograd worker's for a checkpoint's
recompute). So a kernel entry point another thread calls while a record
runs is not routed into it. With None, each hook is one attribute test
and then exactly what the code did without it:

``trips(site, n)``
    a loop's iterations, ``range(n)``. Under a folding recorder a loop
    whose iterations have identical shapes runs three: its first and last
    iterations as they are, and between them one that stands for the
    other ``n - 2``, its record multiplied by ``n - 2`` (the reference's
    while-loop trip counts).
``fill(items, n)``
    the list such a loop appended to, its middle entry repeated ``n - 2``
    times when the loop was folded (so a ``cat`` or ``stack`` after it has
    the unfolded shape).
``pinned(fn)``
    ``fn`` recorded at the multiplier in force where it was wrapped: a
    checkpointed function, whose recompute in the backward must count as
    often as its forward did.

The kernel entry points (``kernels/ops.py``) call
``ACTIVE.recorder.kernel(...)`` when one is active: the kernel is one opaque
entry charged its operands and results, as a ``pallas_call`` is one
equation of the reference's jaxpr.
"""
from __future__ import annotations

import threading


class _Active(threading.local):
    #: this thread's active ``launch.hlo_analysis.Recorder``, or None
    recorder = None


ACTIVE = _Active()


def trips(site: str, n: int):
    rec = ACTIVE.recorder
    if rec is None:
        return range(n)
    return rec.trips(site, n)


def fill(items: list, n: int) -> list:
    if ACTIVE.recorder is None or len(items) == n:
        return items
    return items[:1] + items[1:2] * (n - 2) + items[2:]


def pinned(fn):
    rec = ACTIVE.recorder
    if rec is None:
        return fn
    return rec.pinned(fn)
