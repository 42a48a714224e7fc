"""Faults a run of the cells can have, planted in the timed path, for the
tests that see ``correct`` come out false and for readings on the card
(``calibrate --fault``). Each wraps a method of the program for as long as
``plant`` is entered."""
from __future__ import annotations

import contextlib


def _unchanged(orig):
    """The step returns its tables unchanged: it runs on a copy."""
    def step(self, params, aux, tables, batch, ef, nf=None):
        from repro_torch.core import mailbox
        copy = mailbox.VertexState(*(t.clone() for t in tables))
        return orig(self, params, aux, copy, batch, ef, nf)
    return step


def _altered(orig):
    """Every source embedding altered by 1e-3 where the step produces it."""
    def step(self, *a, **k):
        out = orig(self, *a, **k)
        return out._replace(emb_src=out.emb_src * (1 + 1e-3))
    return step


def _half(orig):
    """Half of each tenant's batch left out (its rows masked invalid)."""
    def step(self, batches):
        out = {}
        for tid, (s, d, e, ts, v) in batches.items():
            v = v.copy()
            v[len(v) // 2:] = False
            out[tid] = (s, d, e, ts, v)
        return orig(self, out)
    return step


def _one_slot(orig):
    """The last tenant's source embeddings altered by 1e-3 in every round:
    one slot of the coalesced round wrong."""
    def step(self, batches):
        out = orig(self, batches)
        tid = list(batches)[-1]
        out[tid] = out[tid]._replace(emb_src=out[tid].emb_src * (1 + 1e-3))
        return out
    return step


#: name -> (class path, method, wrapper)
FAULTS = {
    "state_unchanged": ("pipeline", "batched_step", _unchanged),
    "answer_altered": ("pipeline", "batched_step", _altered),
    "half_batch_left_out": ("session", "step", _half),
    "one_slot_altered": ("session", "step", _one_slot),
}


@contextlib.contextmanager
def plant(name: str):
    """The program with fault ``name`` planted, for the ``with`` block."""
    from repro_torch.core.pipeline import TGNPipeline
    from repro_torch.serving.session import SessionManager

    where, method, wrap = FAULTS[name]
    cls = TGNPipeline if where == "pipeline" else SessionManager
    orig = getattr(cls, method)
    setattr(cls, method, wrap(orig))
    try:
        yield
    finally:
        setattr(cls, method, orig)
