"""Sharded tenant fabric, and tenant snapshots, restore and migration.

Port of ``repro.serving.cluster``:

  * ``ShardedSessionManager`` — the session on a device mesh
    (``distributed/tgn_sharding.py``): same API, same trajectories. Each
    cohort's slots are padded to a multiple of the mesh's ``tenant`` axis
    (pad slots are idle, a bitwise no-op) and cut into contiguous tenant
    shards, each with tables of its own on its device; parameters and
    feature stores are replicated once a distinct device. A ``vertex``
    axis also splits each tenant's V rows over the shard's vertex group.
    The step has no cross-tenant reduction, and every torch product runs
    on one tenant's rows at a time (``utils.per_tenant``), so a tenant's
    trajectory is bit for bit the unsharded session's.

  * snapshot / restore / migration on any manager — built on
    ``distributed/checkpoint.py`` (tmp dir + rename, a crc32 a leaf,
    versioned steps) in the reference's on-disk format: a tenant's
    VertexState plus its variant and config is saved under
    ``<root>/<tenant>/step_XXXXXXXX/``, a snapshot either package wrote
    restores in the other, and it restores onto any mesh shape or the
    unsharded session (the target places the rows).

Capture: the port commits a cohort's tables in place, so a snapshot
cannot hold references to them the way the reference holds its immutable
arrays. ``_capture_tenant`` copies the tenant's rows into pinned host
buffers with non-blocking copies issued on the serving thread's stream,
and records a CUDA event after them. The stream runs them before any
later round's in-place commit, and whoever writes the snapshot (the
caller, or a ``TenantSnapshotWriter`` worker thread) waits for the event
before it reads the buffers.

::

    mgr = ShardedSessionManager(params, edge_feats, model=cfg,
                                mesh="tenant=4,vertex=2")
    a = mgr.add_tenant()
    mgr.step({a: batch})
    snapshot_tenant(mgr, a, "/ckpt/fleet", step=rounds)
    # ... later, in another session of any mesh shape:
    b = restore_tenant(other_mgr, "/ckpt/fleet", a)
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.core import mailbox, pipeline as pl, tgn
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import tgn_sharding as tsh
from repro_torch.serving.session import (DEFAULT_PARAMS, SessionManager,
                                         _Cohort, _mark, to_device_tree)


class _Shard:
    """Slots ``[lo, lo + slots)`` of a sharded cohort, on one vertex group
    (``devices``; its first device runs the launch).

    Without a vertex split (``ranges`` None) the shard's tables are
    stacked tables of their own on the first device: ``slots·V + 1``
    rows, its own scratch row, its row ids from its own base. With one,
    device j owns rows ``ranges[j]`` of every slot: the first device's
    range is held in ``tables`` itself, every other device's in a part of
    its own (``parts``). A launch assembles the group's rows in
    ``tables`` with peer copies from the parts, runs the same step there,
    and writes each part's range back to its owner: the analogue of the
    all-gather XLA places before a Pallas call on a sharded operand (the
    kernels gather rows by id inside their bodies). ``exchanged`` counts
    the bytes those copies move."""

    def __init__(self, cohort: "_ShardedCohort", lo: int, states: list,
                 devices: list, ranges, exchanged):
        self.lo, self.slots, self.V = lo, len(states), cohort.cfg.n_nodes
        self.device = devices[0]
        self.pipeline, self.params, self.aux = cohort.on(self.device)
        self.ranges = ranges
        self._exchanged = exchanged
        self.tables = mailbox.stack_states(
            [mailbox.VertexState(*(t.to(self.device) for t in st))
             for st in states], self.pipeline.init_state())
        #: ``((a, b), part)`` for each device of the group after the first
        self.parts = [] if ranges is None else [
            ((a, b), mailbox.VertexState(*(
                torch.cat([t[a:b] for t in col]).to(d)
                for col in zip(*states))))
            for d, (a, b) in zip(devices[1:], ranges[1:])]

    def _held(self) -> list:
        """``[(a, b, rows of every slot), ...]`` where each range lives:
        leaves of (slots, b - a, ...) views."""
        c, V = self.slots, self.V
        a, b = (0, V) if self.ranges is None else self.ranges[0]
        held = [(a, b, mailbox.VertexState(*(
            t[:c * V].view(c, V, *t.shape[1:])[:, a:b]
            for t in self.tables)))]
        return held + [(a, b, mailbox.VertexState(*(
            t.view(c, b - a, *t.shape[1:]) for t in part)))
            for (a, b), part in self.parts]

    def pieces(self, k: int) -> list:
        """Local slot ``k``'s rows where they live (``_Cohort.pieces``)."""
        return [(a, b, mailbox.VertexState(*(t[k] for t in rows)))
                for a, b, rows in self._held()]

    def _exchange(self, tables: mailbox.VertexState, gather: bool) -> None:
        """Copy every other device's range into (``gather``) or out of
        the assembled tables."""
        c, V = self.slots, self.V
        moved = 0
        for (a, b), part in self.parts:
            for whole, mine in zip(tables, part):
                whole = whole[:c * V].view(c, V, *whole.shape[1:])[:, a:b]
                mine = mine.view(c, b - a, *mine.shape[1:])
                dst, src = (whole, mine) if gather else (mine, whole)
                dst.copy_(src, non_blocking=True)
                moved += mine.numel() * mine.element_size()
        self._exchanged.inc(moved)

    def step(self, edge_feats, node_feats, scratch: bool,
             batch: tuple) -> tgn.BatchOut:
        """Advance the shard's slots by ``batch`` (its rows of the cohort's
        stacked batch), in place unless ``scratch``."""
        batch = tuple(x.to(self.device, non_blocking=True) for x in batch)
        tables = self.tables
        if scratch:
            tables = mailbox.VertexState(*(t.clone() for t in tables))
        self._exchange(tables, gather=True)
        out = self.pipeline.batched_step(self.params, self.aux, tables, batch,
                                         edge_feats, node_feats)
        if not scratch:
            self._exchange(tables, gather=False)
        return out

    def finite(self) -> torch.Tensor:
        """``(slots,)`` bool: every floating row of the slot is finite."""
        c = self.slots
        flags = torch.ones((c,), dtype=torch.bool, device=self.device)
        for _a, _b, rows in self._held():
            for leaf in rows:
                if leaf.dtype.is_floating_point:
                    flags &= torch.isfinite(leaf).reshape(c, -1).all(
                        dim=1).to(self.device)
        return flags


class _ShardedCohort(_Cohort):
    """A cohort whose slots live in tenant shards on the fabric mesh."""

    def __init__(self, cfg: tgn.TGNConfig, use_kernels, replicas: dict,
                 mesh: tsh.TenantMesh, reserve=None,
                 param_set: str = DEFAULT_PARAMS, exchanged=None):
        self.mesh = mesh
        first = mesh.devices.reshape(-1)[0]
        super().__init__(cfg, use_kernels, replicas[first], first,
                         reserve=reserve, param_set=param_set)
        self._replicas = replicas
        self._on = {first: (self.pipeline, self.params, self.aux)}
        self._exchanged = exchanged
        self.ranges = tsh.vertex_ranges(mesh, tgn.init_state(cfg, "meta"))
        self.shards: list[_Shard] = []

    def on(self, device) -> tuple:
        """``(pipeline, params, aux)`` of the cohort on ``device``."""
        if device not in self._on:
            pipe = pl.build_pipeline(self.cfg, self.tier, device=device)
            params = self._replicas[device]
            self._on[device] = (pipe, params, pipe.prepare(params))
        return self._on[device]

    def _target_capacity(self, n: int) -> int:
        """The reserve's class (or ``n``), rounded up to a multiple of the
        mesh's tenant axis."""
        return tsh.tenant_capacity(super()._target_capacity(n), self.mesh)

    def _fit(self, states: list) -> None:
        cap = self._capacity_for(len(states))
        init = self.pipeline.init_state()
        states = states + [init] * (cap - len(states))
        groups = self.mesh.groups()
        c = cap // len(groups)
        self.shards = [_Shard(self, k * c, states[k * c:(k + 1) * c], g,
                              self.ranges, self._exchanged)
                       for k, g in enumerate(groups)]
        self.capacity = cap

    def _empty(self) -> None:
        self.shards, self.capacity = [], 0

    def _shard_of(self, i: int) -> tuple:
        shard = self.shards[i // self.shards[0].slots]
        return shard, i - shard.lo

    def view(self, i: int):
        raise TypeError("a sharded cohort's slot lives in the pieces of "
                        "its shard: read it with read_slot or pieces")

    def pieces(self, i: int) -> list:
        shard, k = self._shard_of(i)
        return shard.pieces(k)

    def slot_shardings(self, i: int) -> mailbox.VertexState:
        """The slot's vertex group, split as its shard keeps it."""
        return self._group_shardings(self.mesh.groups()[
            i // self.shards[0].slots])

    def lanes(self, feats, scratch: bool = False) -> list:
        """One lane a tenant shard, on the shard's device."""
        return [(s.lo, s.slots, s.pipeline,
                 functools.partial(s.step, *feats(s.device), scratch))
                for s in self.shards]

    def finite_slots(self) -> torch.Tensor:
        return torch.cat([s.finite().to(self.device) for s in self.shards])


class ShardedSessionManager(SessionManager):
    """SessionManager on a device mesh: same API, same trajectories.

    ``mesh`` is a ``tgn_sharding.TenantMesh`` or a spec for
    ``make_tenant_mesh`` (``"8"``, ``"tenant=4,vertex=2"``, ``None`` =
    every CUDA device on the tenant axis); a mesh that needs more devices
    than there are raises. The session's device is the mesh's first:
    rounds are staged there (one copy), and each tenant shard takes its
    rows of the super-batch to its own device. Parameter sets and the
    feature stores are replicated once a distinct device. Tenant
    lifecycle, idle masking, chronological commits, snapshots and
    metrics are the unsharded session's. ``fabric.vertex_exchange_bytes``
    in ``obs`` counts the bytes the vertex axis's copies move.
    """

    def __init__(self, params: dict, edge_feats, node_feats=None, *,
                 mesh=None, **kw):
        if "device" in kw:
            raise TypeError("the mesh places a sharded session: pass "
                            "mesh=, not device=")
        if not isinstance(mesh, tsh.TenantMesh):
            mesh = tsh.make_tenant_mesh(mesh)
        self.mesh = mesh
        kw["device"] = mesh.devices.reshape(-1)[0]
        #: id(placed set) -> {device: the set there}
        self._replicas: dict[int, dict] = {}
        super().__init__(params, edge_feats, node_feats, **kw)
        self._feat_replicas = {
            d: (self.edge_feats.to(d), None if self.node_feats is None
                else self.node_feats.to(d))
            for d in mesh.distinct_devices}

    def _place_params(self, params: dict) -> dict:
        """Replicate a registered parameter set on every distinct device;
        the set on the first device is the registered one."""
        reps = {d: to_device_tree(params, d)
                for d in self.mesh.distinct_devices}
        first = reps[self.mesh.devices.reshape(-1)[0]]
        self._replicas[id(first)] = reps
        return first

    def _feats(self, device) -> tuple:
        return self._feat_replicas[device]

    def _make_cohort(self, cfg: tgn.TGNConfig, use_kernels,
                     param_set: str = DEFAULT_PARAMS) -> _ShardedCohort:
        params = self.param_store.get(param_set)
        return _ShardedCohort(
            cfg, use_kernels, self._replicas[id(params)], self.mesh,
            reserve=self.reserve, param_set=param_set,
            exchanged=self.obs.counter("fabric.vertex_exchange_bytes"))

    def describe(self) -> dict:
        return {**super().describe(), "mesh": self.mesh.shape}


class _Capture:
    """A tenant's state copied to host memory, and the events after the
    copies (none on the CPU, where they are done when issued)."""

    def __init__(self, tree: dict, meta: dict, done: list):
        self.tree = tree
        self.meta = meta
        self._done = done

    def wait(self) -> dict:
        """The host tree, once the devices have written it."""
        for ev in self._done:
            ev.synchronize()
        return self.tree


def _capture_tenant(mgr: SessionManager, tid: str,
                    extra_meta: dict | None = None) -> _Capture:
    """Copy ``tid``'s state to host memory (pinned buffers, non-blocking),
    each piece of its rows on the stream of the device that holds it, one
    event after them there; with its manifest meta."""
    cohort = mgr.cohort_of(tid)
    pieces = cohort.pieces(cohort.tids.index(tid))
    V = cohort.cfg.n_nodes
    cuda = mgr.device.type == "cuda"
    tree = {f: torch.empty((V, *t.shape[1:]), dtype=t.dtype,
                           pin_memory=cuda)
            for f, t in zip(mailbox.VertexState._fields, pieces[0][2])}
    done = []
    for lo, hi, rows in pieces:
        for f, t in zip(mailbox.VertexState._fields, rows):
            tree[f][lo:hi].copy_(t, non_blocking=cuda)
        ev = _mark(rows.memory.device)
        if ev is not None:
            done.append(ev)
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


def _slot_shardings(cohort, tid: str) -> dict:
    """Where ``tid``'s restored leaves go: the devices that keep its rows
    (``_tree_like``'s structure)."""
    return cohort.slot_shardings(cohort.tids.index(tid))._asdict()


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
    place = _slot_shardings(cohort, new)
    if step is None:
        state, rmeta, _used = ckpt.restore_valid(d, _tree_like(cohort),
                                                 shardings=place)
    else:
        state, rmeta = ckpt.restore(d, _tree_like(cohort), step=step,
                                    shardings=place)
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
    place = _slot_shardings(cohort, tid)
    if step is None:
        state, meta, used = ckpt.restore_valid(d, _tree_like(cohort),
                                               shardings=place)
    else:
        state, meta = ckpt.restore(d, _tree_like(cohort), step=step,
                                   shardings=place)
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
