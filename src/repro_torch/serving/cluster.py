"""Tenant snapshots, restore and migration for the port's session.

Port of the single-device half of ``repro.serving.cluster`` (the mesh
half, ``ShardedSessionManager``, is not ported yet). Built on
``distributed/checkpoint.py`` (tmp dir + rename, a crc32 a leaf,
versioned steps) in the reference's on-disk format: a tenant's
VertexState plus its variant and config is saved under
``<root>/<tenant>/step_XXXXXXXX/``, and a snapshot either package wrote
restores in the other.

Capture: the port commits a cohort's tables in place, so a snapshot
cannot hold references to them the way the reference holds its immutable
arrays. ``_capture_tenant`` copies the tenant's rows into pinned host
buffers with non-blocking copies issued on the serving thread's stream,
and records a CUDA event after them. The stream runs them before any
later round's in-place commit, and whoever writes the snapshot (the
caller, or a ``TenantSnapshotWriter`` worker thread) waits for the event
before it reads the buffers.

::

    mgr = SessionManager(params, edge_feats, model=cfg)
    a = mgr.add_tenant()
    mgr.step({a: batch})
    snapshot_tenant(mgr, a, "/ckpt/fleet", step=rounds)
    # ... later, in another session:
    b = restore_tenant(other_mgr, "/ckpt/fleet", a)
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.core import mailbox, pipeline as pl
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.serving.session import (DEFAULT_PARAMS, SessionManager,
                                         _mark)


class _Capture:
    """A tenant's state copied to host memory, and the event after the
    copies (None on the CPU, where they are done when issued)."""

    def __init__(self, tree: dict, meta: dict, done):
        self.tree = tree
        self.meta = meta
        self._done = done

    def wait(self) -> dict:
        """The host tree, once the device has written it."""
        if self._done is not None:
            self._done.synchronize()
        return self.tree


def _capture_tenant(mgr: SessionManager, tid: str,
                    extra_meta: dict | None = None) -> _Capture:
    """Copy ``tid``'s state to host memory on the serving thread's stream
    (pinned buffers, non-blocking, one event after them), with its
    manifest meta."""
    cohort = mgr.cohort_of(tid)
    view = cohort.view(cohort.tids.index(tid))
    cuda = mgr.device.type == "cuda"
    tree = {}
    for f, t in zip(mailbox.VertexState._fields, view):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda)
        host.copy_(t, non_blocking=cuda)
        tree[f] = host
    done = _mark(mgr.device)
    meta = {"tenant": tid,
            "variant": pl.variant_name(cohort.cfg),
            "config": dataclasses.asdict(cohort.cfg),
            # the tenant's resolved tier: a restore resumes on the same
            # numerics
            "use_kernels": cohort.tier,
            # the weights it serves on and their digest: a restore resumes
            # on the same weights
            "param_set": cohort.param_set,
            "params_digest": mgr.param_store.digest(cohort.param_set)}
    if extra_meta:
        meta.update(extra_meta)
    return _Capture(tree, meta, done)


def snapshot_tenant(mgr: SessionManager, tid: str, root: str, *,
                    step: int = 0, keep: int = 3,
                    extra_meta: dict | None = None,
                    keep_floor: int | None = None) -> str:
    """Atomically snapshot one tenant's VertexState and serving metadata
    under ``<root>/<tid>/step_XXXXXXXX/`` (``checkpoint.save``, the last
    ``keep`` steps kept). ``step`` is the caller's stream position. With a
    journal the caller records its replay cursor through
    ``extra_meta={"journal": journal.cursor(tid)}`` and pins the journal's
    anchor step with ``keep_floor``."""
    cap = _capture_tenant(mgr, tid, extra_meta)
    return ckpt.save(os.path.join(root, tid), step, cap.wait(),
                     meta=cap.meta, keep=keep, floor=keep_floor)


class TenantSnapshotWriter:
    """Background per-tenant snapshot writer: a round never waits for
    snapshot IO.

    ``submit`` captures the tenant's state on the calling thread (copies
    to pinned host memory issued on its stream, no wait) and hands the
    wait for them and the atomic ``checkpoint.save`` to a worker thread.
    At most one snapshot a tenant is in flight: a submission while the
    tenant's previous write runs is skipped (``skipped``).

    A failed write attempt is retried on the worker with capped
    exponential backoff (``retries`` attempts after the first,
    ``backoff_s`` doubling up to ``backoff_cap_s``); retries and
    exhausted failures count in ``obs`` (``snapshot.retries`` /
    ``snapshot.failures``), and a failure raises at the next
    ``submit``/``join``/``wait``. With an armed fault plan on the manager
    each attempt runs its ``on_snapshot_write`` hook.
    """

    def __init__(self, root: str, *, keep: int = 3, max_workers: int = 2,
                 retries: int = 2, backoff_s: float = 0.05,
                 backoff_cap_s: float = 1.0, obs=None, sleep=None):
        self.root = root
        self.keep = keep
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.obs = obs                  # MetricsRegistry or None
        self._sleep = sleep if sleep is not None else time.sleep
        self.skipped = 0
        self.written = 0
        self._pool = ThreadPoolExecutor(max_workers=max_workers)
        self._inflight: dict[str, object] = {}

    def submit(self, mgr: SessionManager, tid: str, *, step: int = 0,
               extra_meta: dict | None = None,
               keep_floor: int | None = None) -> bool:
        """Queue a snapshot of ``tid`` at ``step``; False when the
        tenant's previous one is still in flight (skipped). A previous
        write that failed raises here, its slot cleared first."""
        prev = self._inflight.get(tid)
        if prev is not None:
            if not prev.done():
                self.skipped += 1
                return False
            try:
                prev.result()
            except Exception:
                del self._inflight[tid]
                raise
        cap = _capture_tenant(mgr, tid, extra_meta)
        faults = getattr(mgr, "_faults", None)

        def work():
            tree = cap.wait()
            delay = self.backoff_s
            for attempt in range(self.retries + 1):
                try:
                    if faults is not None:
                        faults.on_snapshot_write(tid)
                    return ckpt.save(os.path.join(self.root, tid), step,
                                     tree, meta=cap.meta, keep=self.keep,
                                     floor=keep_floor)
                except Exception:
                    if attempt >= self.retries:
                        if self.obs is not None:
                            self.obs.counter("snapshot.failures").inc()
                        raise
                    if self.obs is not None:
                        self.obs.counter("snapshot.retries").inc()
                    self._sleep(min(delay, self.backoff_cap_s))
                    delay *= 2

        self._inflight[tid] = self._pool.submit(work)
        self.written += 1
        return True

    def join(self, tid: str) -> None:
        """Wait for ``tid``'s write in flight, if any, clearing its slot;
        raises its failure. The guard calls this before a restore."""
        fut = self._inflight.pop(tid, None)
        if fut is not None:
            fut.result()

    def wait(self) -> None:
        """Join every write in flight, then raise the first failure."""
        errors = []
        for tid, fut in list(self._inflight.items()):
            try:
                fut.result()
            except Exception as e:
                errors.append((tid, e))
            del self._inflight[tid]
        if errors:
            tid, err = errors[0]
            raise RuntimeError(
                f"background snapshot of tenant {tid!r} failed "
                f"({len(errors)} failure(s) total)") from err

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)


def snapshot_meta(root: str, tid: str, *, step: int | None = None) -> dict:
    """A snapshot's manifest meta, without loading any array."""
    d = os.path.join(root, tid)
    if step is None:
        step = ckpt.latest_step(d)
        if step is None:
            raise FileNotFoundError(f"no snapshot for tenant {tid!r} under "
                                    f"{root}")
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)["meta"]


def list_snapshots(root: str) -> dict:
    """``{tenant id: latest step}`` of every restorable snapshot."""
    if not os.path.isdir(root):
        return {}
    out = {}
    for tid in sorted(os.listdir(root)):
        step = ckpt.latest_step(os.path.join(root, tid))
        if step is not None:
            out[tid] = step
    return out


def _tree_like(cohort) -> dict:
    return cohort.pipeline.init_state()._asdict()


def restore_tenant(mgr: SessionManager, root: str, tid: str, *,
                   name: str | None = None, step: int | None = None,
                   params: str | None = None, journal=None) -> str:
    """Admit a snapshotted tenant into ``mgr`` and return its id.

    The snapshot's config must equal the one ``mgr`` resolves for its
    variant, and it resumes on the parameter set its manifest names,
    whose digest must match (``params=<name>`` rebinds it onto another
    registered set instead, without the digest check). With ``step=None``
    a corrupt newest step is skipped with a warning
    (``checkpoint.restore_valid``); an explicit ``step`` is strict. With
    ``journal`` (an ``EventJournal``) every journaled flush past the
    restored manifest's cursor is replayed through ``mgr.step``, so the
    tenant resumes where it left off, not at its snapshot;
    ``journal.last_replay.pending`` holds accepted events no flush took.
    """
    d = os.path.join(root, tid)
    meta = _meta_with_fallback(root, tid, step)
    want = meta["config"]
    pname = params if params is not None else meta.get("param_set",
                                                       DEFAULT_PARAMS)
    try:
        mgr.param_store.get(pname)
    except ValueError as e:
        raise ValueError(
            f"snapshot {tid!r} is bound to param set {pname!r} which this "
            f"session has not registered — register_params({pname!r}, ...) "
            "with the original weights before restoring, or pass params= "
            f"to rebind explicitly ({e})") from None
    new = mgr.add_tenant(meta["variant"], name=name or tid,
                         reservoir_tau=want.get("reservoir_tau"),
                         use_kernels=meta.get("use_kernels"),
                         params=pname)
    cohort = mgr.cohort_of(new)
    got = dataclasses.asdict(cohort.cfg)
    if got != want:
        mgr.remove_tenant(new)
        diff = sorted(k for k in set(want) | set(got)
                      if want.get(k) != got.get(k))
        raise ValueError(
            f"snapshot {tid!r} was taken with config fields "
            f"{ {k: want.get(k) for k in diff} } but this session resolves "
            f"{ {k: got.get(k) for k in diff} } — shared parameter axes and "
            "table dims must match to continue the trajectory")
    if params is None and meta.get("params_digest") is not None:
        have = mgr.param_store.digest(pname)
        if have != meta["params_digest"]:
            mgr.remove_tenant(new)
            raise ValueError(
                f"snapshot {tid!r} records param set {pname!r} with digest "
                f"{meta['params_digest']} but this session's {pname!r} "
                f"digests {have} — the trajectory would continue under "
                "different weights; register the original parameters, or "
                "pass params= to rebind explicitly")
    if step is None:
        state, rmeta, _used = ckpt.restore_valid(d, _tree_like(cohort),
                                                 device=mgr.device)
    else:
        state, rmeta = ckpt.restore(d, _tree_like(cohort), step=step,
                                    device=mgr.device)
    mgr.set_state(new, mailbox.VertexState(**state))
    if journal is not None and rmeta.get("journal") is not None:
        journal.replay(tid, rmeta["journal"], mgr.step, as_tid=new)
    return new


def truncate_journal(journal, root: str, tid: str) -> int | None:
    """Truncate ``tid``'s journal up to the oldest retained snapshot's
    cursor, so every snapshot the checkpoint GC keeps can still anchor a
    full replay. A corrupt or cursor-less oldest manifest truncates
    nothing. Returns the anchor step (pass it as the next snapshot's
    ``keep_floor``), or None."""
    for s in ckpt.list_steps(os.path.join(root, tid)):
        try:
            meta = snapshot_meta(root, tid, step=s)
        except ckpt.CORRUPTION_ERRORS:
            return None
        cur = meta.get("journal")
        if cur is None:
            return None
        journal.truncate_upto(tid, cur)
        return s
    return None


def _meta_with_fallback(root: str, tid: str, step: int | None) -> dict:
    """The manifest meta of ``step``, or with ``step=None`` of the newest
    step whose manifest parses (a corrupt one is skipped with a
    warning)."""
    if step is not None:
        return snapshot_meta(root, tid, step=step)
    d = os.path.join(root, tid)
    for s in reversed(ckpt.list_steps(d)):
        try:
            return snapshot_meta(root, tid, step=s)
        except ckpt.CORRUPTION_ERRORS as e:
            warnings.warn(
                f"snapshot manifest for tenant {tid!r} step {s} is "
                f"corrupt ({e}); falling back to the newest prior step")
    raise FileNotFoundError(f"no restorable snapshot for tenant {tid!r} "
                            f"under {root}")


def restore_tenant_state(mgr: SessionManager, root: str, tid: str, *,
                         step: int | None = None) -> int:
    """Reload an attached tenant's VertexState in place from its newest
    valid snapshot (the guard's restore): the tenant keeps its slot. The
    recorded config must equal the cohort's and the recorded params
    digest its set's (the tier may differ: a degraded lane restores the
    same numerics a tier lower). Returns the step restored from."""
    cohort = mgr.cohort_of(tid)
    d = os.path.join(root, tid)
    if step is None:
        state, meta, used = ckpt.restore_valid(d, _tree_like(cohort),
                                               device=mgr.device)
    else:
        state, meta = ckpt.restore(d, _tree_like(cohort), step=step,
                                   device=mgr.device)
        used = step
    want = meta.get("config")
    have = dataclasses.asdict(cohort.cfg)
    if want is not None and want != have:
        diff = sorted(k for k in set(want) if want.get(k) != have.get(k))
        raise ValueError(
            f"snapshot {tid!r} step {used} was taken with config fields "
            f"{ {k: want.get(k) for k in diff} } but the tenant's lane "
            "resolves differently — an in-place restore must land in the "
            "SAME lane config")
    digest = meta.get("params_digest")
    if digest is not None and digest != mgr.param_store.digest(
            cohort.param_set):
        raise ValueError(
            f"snapshot {tid!r} step {used} records params digest "
            f"{digest} but the lane's {cohort.param_set!r} set digests "
            f"{mgr.param_store.digest(cohort.param_set)} — the "
            "trajectory would resume under different weights")
    mgr.set_state(tid, mailbox.VertexState(**state))
    return used


def migrate_tenant(src: SessionManager, tid: str, dst: SessionManager,
                   root: str, *, step: int | None = None,
                   name: str | None = None, keep: int = 3) -> str:
    """Move a live tenant between two sessions through a durable snapshot:
    snapshot on ``src``, restore into ``dst``, release the source slot.
    Returns the tenant's id in ``dst``. ``step`` defaults to one past the
    tenant's latest snapshot under ``root``."""
    if step is None:
        prev = ckpt.latest_step(os.path.join(root, tid))
        step = 0 if prev is None else prev + 1
    snapshot_tenant(src, tid, root, step=step, keep=keep)
    new = restore_tenant(dst, root, tid, name=name, step=step)
    src.remove_tenant(tid)
    return new
