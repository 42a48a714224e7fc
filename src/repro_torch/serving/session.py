"""Multi-tenant streaming sessions: many edge streams, one round of launches.

Port of ``repro.serving.session``. ``SessionManager`` hosts many
independent edge streams (tenants: per-customer or per-region feeds) over
a registry of named parameter sets (the teacher, its distilled students):

  * every tenant owns its vertex state (memory, mailbox, neighbour ring)
    and picks its own variant and kernel tier;
  * tenants with the same variant, tier and parameter set form a
    *cohort*: their states are stacked into one set of tables
    (``mailbox.stack_states``, tenant t's vertex v at row t·V + v) and
    ``TGNPipeline.batched_step`` advances the whole cohort in place, every
    kernel launched once over the stacked rows of all its tenants, with
    last-write-wins and ring slots raced within each tenant;
  * a round (``step``) issues every cohort's step back to back in one
    call (``pipeline.CoalescedRound``), fed by one host-to-device copy of
    the whole super-batch from pinned, double-buffered host buffers; with
    ``coalesce=False`` each cohort is stacked and launched on its own
    (the baseline);
  * a tenant that submits no batch in a round is masked (all
    ``valid=False``): its rows' writes go to the scratch row, so its state
    does not change.

Numerics contract (``tests/test_torch_session.py``): a tenant's
trajectory in a cohort of N equals, bit for bit, the same stream served
alone, because each row of every kernel depends only on that row's
inputs and every torch product runs on one tenant's rows at a time
(``utils.per_tenant``). ``StreamingEngine`` is a one-tenant view of this
class; ``serving/cluster.py``'s ``ShardedSessionManager`` lays the same
cohorts out on a device mesh.

Steps do not block on the device; ``sync()`` (and ``summary()``) drain
the fleet. A session runs on ``cuda`` unless it is given ``device="cpu"``.

Hooks of the online serving stack (``serving/frontend.py``, ``guard.py``,
``faults.py``, ``obs/``): ``set_tracer`` (a sampled ``RoundTracer``: only
a sampled round records spans and fences the device, with a CUDA event
and its synchronize), ``set_slo`` (per-tenant SLO burn), ``set_faults``
(a deterministic fault plan; unarmed, one attribute test a round),
``quarantine`` (a tenant's batches are dropped and its slot runs idle,
which leaves its rows and its cohort-mates' unchanged) and
``guarded_step`` (the round through an attached ``FleetGuard``).
"""
from __future__ import annotations

import functools
import time
from typing import Iterable, Mapping

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import mailbox, pipeline as pl, stages, tgn
from repro_torch.data.stream import EdgeBatch
from repro_torch.distributed import tgn_sharding as tsh
from repro_torch.distributed.checkpoint import tree_digest
from repro_torch.obs import Histogram, MetricsRegistry
from repro_torch.utils import resolve_device


def to_device_tree(params, device):
    """Parameters as tensors on ``device`` (numpy leaves are converted)."""
    if isinstance(params, dict):
        return {k: to_device_tree(v, device) for k, v in params.items()}
    return torch.as_tensor(params, device=device)


def _fields(batch) -> tuple:
    if isinstance(batch, EdgeBatch):
        return (batch.src, batch.dst, batch.eid, batch.ts, batch.valid)
    return tuple(batch)


def _as_device_tuple(batch, device) -> tuple:
    """An EdgeBatch / 5-tuple as (src, dst, eid, ts, valid) on ``device``."""
    src, dst, eid, ts, valid = _fields(batch)
    src = torch.as_tensor(src, device=device)
    if valid is None:
        valid = torch.ones(src.shape, dtype=torch.bool, device=device)
    return (src, torch.as_tensor(dst, device=device),
            torch.as_tensor(eid, device=device),
            torch.as_tensor(ts, device=device),
            torch.as_tensor(valid, device=device))


def _as_host_tuple(batch) -> tuple:
    """An EdgeBatch / 5-tuple as host numpy (src, dst, eid, ts, valid)."""
    src, dst, eid, ts, valid = (
        None if x is None else
        x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        for x in _fields(batch))
    if valid is None:
        valid = np.ones(src.shape, bool)
    return src, dst, eid, ts, valid


def _mark(device):
    """A CUDA event recorded now on ``device``'s current stream, or None
    on the CPU, where every launch has finished when its call returns."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def _fence(mark) -> None:
    """Wait until the work before ``mark`` has run: the round's only wait
    on the device, made on trace-sampled rounds only."""
    if mark is not None:
        mark.synchronize()


class _HostStager:
    """Pre-allocated, double-buffered host staging of a round's super-batch.

    Two sets of one (5, rows, width) int32 host buffer each (src, dst,
    eid, the bits of ts, valid), pinned on CUDA. A round fills the rows of
    its submitted batches IN PLACE and ships the set with ONE
    non-blocking copy. Rounds alternate sets, so round k+1 is written
    while round k's copy and launches run.

    Reuse gate (the reference's rule): a set is rewritten only after a
    CUDA event recorded after the launches that consumed it
    (``note_consumer``) has completed, not only its copy. On the card only
    the copy reads the host set, so this gate is stricter than the memory
    needs; it also bounds the rounds in flight to two, and it waits on
    work two rounds old, so no round waits for its own launches.

    ``width`` grows sticky to the widest batch seen (fresh buffers);
    extra columns and unsubmitted rows are ``valid=False`` padding.
    """

    def __init__(self, rows: int, width: int, device: torch.device):
        self.rows = int(rows)
        self.width = max(int(width), 1)
        self.device = device
        self._alloc()

    def _event(self):
        """An event recorded now: a set's reuse gate (None on the CPU)."""
        return _mark(self.device)

    def _alloc(self) -> None:
        pin = self.device.type == "cuda"
        self._bufs = [torch.zeros((5, self.rows, self.width),
                                  dtype=torch.int32, pin_memory=pin)
                      for _ in range(2)]
        self._host = [b.numpy() for b in self._bufs]
        #: per set: the event the set's reuse waits for
        self._inflight: list = [None, None]
        self._turn = 0
        self._last = 0

    def ensure_width(self, width: int) -> None:
        """Grow the staged batch width (sticky; fresh buffers)."""
        if width > self.width:
            self.drain()                 # the old sets may still be read
            self.width = int(width)
            self._alloc()

    def stage(self, row_batches: Mapping[int, tuple]) -> tuple:
        """Fill ``{row: host five-tuple}`` into the next set and issue ONE
        copy of it to the device. Unlisted rows are idle
        (``valid=False``). Returns the device (src, dst, eid, ts, valid),
        each (rows, width)."""
        turn = self._turn
        self._turn = 1 - turn
        gate = self._inflight[turn]
        if gate is not None:             # reuse gate: the set's consumer
            gate.synchronize()
        buf = self._host[turn]
        buf.fill(0)                      # deterministic padding rows
        for row, (src, dst, eid, ts, valid) in row_batches.items():
            b = src.shape[0]
            buf[0, row, :b] = src
            buf[1, row, :b] = dst
            buf[2, row, :b] = eid
            buf[3, row, :b] = np.asarray(ts, np.float32).view(np.int32)
            buf[4, row, :b] = valid
        dev = self._bufs[turn].to(self.device, non_blocking=True, copy=True)
        # until its consumer is noted, the set waits for its own copy
        self._inflight[turn] = self._event()
        self._last = turn
        return dev[0], dev[1], dev[2], dev[3].view(torch.float32), dev[4] != 0

    def note_consumer(self) -> None:
        """Gate the last staged set on an event recorded now, after the
        launches that read it were issued."""
        self._inflight[self._last] = self._event()

    def drain(self) -> None:
        """Wait for every set's gate (relayout, teardown)."""
        for gate in self._inflight:
            if gate is not None:
                gate.synchronize()
        self._inflight = [None, None]


def _pad_dev(dev: tuple, B: int) -> tuple:
    """Pad a device tuple to B rows; padding rows are ``valid=False`` (their
    writes are dropped, so results on real rows are unchanged)."""
    pad = B - dev[0].shape[0]
    if pad == 0:
        return dev
    return tuple(torch.nn.functional.pad(x, (0, pad)) for x in dev)


def _idle_dev(B: int, device) -> tuple:
    """An all-masked batch: advances a tenant's slot without changing it."""
    zi = torch.zeros((B,), dtype=torch.int32, device=device)
    return (zi, zi, zi, torch.zeros((B,), dtype=torch.float32, device=device),
            torch.zeros((B,), dtype=torch.bool, device=device))


#: the parameter-set name every tenant serves on unless it names another
DEFAULT_PARAMS = "default"


def _tree_signature(params) -> dict:
    """``{leaf path: (shape, dtype)}`` of a parameter tree."""
    return {path: (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in tree.flatten_with_path(params)}


@functools.lru_cache(maxsize=64)
def _cfg_param_signature(cfg: tgn.TGNConfig) -> dict:
    """The parameter signature ``cfg``'s step consumes (a CPU init)."""
    return _tree_signature(tgn.init_params(torch.Generator().manual_seed(0),
                                           cfg, "cpu"))


class ParamStore:
    """Named, device-resident parameter sets: the per-lane params of the
    coalesced round.

    One set is registered at construction under ``DEFAULT_PARAMS``; more
    arrive through ``register``. A registered set is immutable:
    re-registering a name with byte-identical content is a no-op, with
    other content an error (to swap weights, register a new name, attach
    tenants to it, drain the old). ``digest`` is
    ``checkpoint.tree_digest``: a crc32 over leaf paths and bytes.
    ``place`` puts a set on the session's device.
    """

    def __init__(self, default_params: dict, *, place=None):
        self._place = place if place is not None else (lambda p: p)
        self._sets: dict[str, dict] = {}
        self._digests: dict[str, str] = {}
        self.register(DEFAULT_PARAMS, default_params)

    def register(self, name: str, params: dict) -> dict:
        """Register (and place) a named set; returns the resident tree."""
        if not isinstance(name, str) or not name:
            raise ValueError("param-set name must be a non-empty string, "
                             f"got {name!r}")
        digest = tree_digest(params)
        if name in self._sets:
            if digest != self._digests[name]:
                raise ValueError(
                    f"param set {name!r} is already registered with "
                    f"different content (digest {self._digests[name]} vs "
                    f"{digest}); registered sets are immutable — register "
                    "the new weights under a new name and attach tenants "
                    "to that")
            return self._sets[name]
        self._sets[name] = self._place(params)
        self._digests[name] = digest
        return self._sets[name]

    def get(self, name: str) -> dict:
        if name not in self._sets:
            raise ValueError(
                f"unknown param set {name!r}; registered: "
                f"{sorted(self._sets)}. Register it first "
                "(SessionManager.register_params(name, params)) — "
                "admission never invents weights")
        return self._sets[name]

    def digest(self, name: str) -> str:
        self.get(name)
        return self._digests[name]

    def names(self) -> tuple:
        return tuple(self._sets)

    def __contains__(self, name) -> bool:
        return name in self._sets

    def check_binding(self, name: str, cfg: tgn.TGNConfig) -> None:
        """The named set must fit ``cfg``'s step: the leaf paths, shapes
        and dtypes ``tgn.init_params`` gives that config. Raises with the
        leaves that differ."""
        got = _tree_signature(self.get(name))
        want = _cfg_param_signature(cfg)
        if got == want:
            return
        diff = sorted(k for k in set(want) | set(got)
                      if want.get(k) != got.get(k))
        raise ValueError(
            f"param set {name!r} does not fit a "
            f"{pl.variant_name(cfg)!r} lane: mismatched leaves "
            f"{ {k: {'want': want.get(k), 'got': got.get(k)} for k in diff} }"
            " — the set must be initialized/trained for the tenant's "
            "attention+encoder and table dims")


class _Cohort:
    """Tenants sharing one variant, kernel tier and parameter set: their
    stacked tables and one ``batched_step`` on the cohort's parameters.

    With a ``reserve`` (``admission.CapacityLadder``) the tables hold spare
    idle slots beyond the tenants present: an attach lands in a spare slot
    and a detach leaves its slot idle, with no relayout, until the class
    is exhausted. Without one the tables hold exactly the tenants, and
    shrink when one leaves.

    The session reads and writes a slot's rows through ``pieces`` and
    launches the cohort through ``lanes``; a sharded cohort
    (``serving/cluster.py``) lays the same slots out over a device mesh
    behind these two methods.
    """

    def __init__(self, cfg: tgn.TGNConfig, use_kernels, params: dict,
                 device, reserve=None, param_set: str = DEFAULT_PARAMS):
        self.cfg = cfg
        self.reserve = reserve
        self.pipeline = pl.build_pipeline(cfg, use_kernels=use_kernels,
                                          device=device)
        self.device = self.pipeline.device
        #: resolved tier: a fused lane and a staged lane of one variant are
        #: two cohorts
        self.tier = self.pipeline.tier
        self.params = params
        self.param_set = param_set
        # folded LUT tables and kernel packs, prepared once per cohort
        self.aux = self.pipeline.prepare(params)
        self.tids: list[str] = []
        #: stacked tables (``mailbox.stack_states``), capacity·V + 1 rows
        self.state: mailbox.VertexState | None = None
        self.capacity = 0

    @property
    def size(self) -> int:
        return len(self.tids)

    @property
    def spare(self) -> int:
        """Idle slots beyond the tenants present."""
        return self.capacity - self.size

    def view(self, i: int) -> mailbox.VertexState:
        """Slot ``i``'s (V, ...) rows of the stacked tables (views)."""
        return mailbox.tenant_view(self.state, i, self.cfg.n_nodes)

    def pieces(self, i: int) -> list:
        """Slot ``i``'s rows where they live: ``[(lo, hi, rows), ...]``,
        ``rows`` views of the slot's vertex rows ``[lo, hi)``."""
        return [(0, self.cfg.n_nodes, self.view(i))]

    def read_slot(self, i: int) -> mailbox.VertexState:
        """A copy of slot ``i``'s (V, ...) rows on the cohort's device."""
        pieces = self.pieces(i)
        return mailbox.VertexState(*(
            torch.cat([p[f].to(self.device) for _, _, p in pieces])
            for f in range(len(mailbox.VertexState._fields))))

    def write_slot(self, i: int, st: mailbox.VertexState) -> None:
        """Copy ``st`` into slot ``i``'s rows. A leaf is the (V, ...) rows,
        or a tuple of the pieces ``slot_shardings`` places."""
        for j, (lo, hi, rows) in enumerate(self.pieces(i)):
            for dst, src in zip(rows, st):
                dst.copy_(src[j] if isinstance(src, tuple) else src[lo:hi])

    def slot_shardings(self, i: int) -> mailbox.VertexState:
        """Where a restored leaf of slot ``i`` goes
        (``checkpoint.restore(..., shardings=)``): the cohort's device."""
        return self._group_shardings([self.device])

    def _group_shardings(self, devices) -> mailbox.VertexState:
        """A slot's rows split over ``devices`` as the sharding rules
        split a vertex group's (not at all on one device)."""
        mesh = tsh.TenantMesh(devices, (tsh.VERTEX_AXIS,))
        return tsh.make_shardings(mesh, tsh.state_specs(
            mesh, tgn.init_state(self.cfg, "meta"), stacked=False))

    def lanes(self, feats, scratch: bool = False) -> list:
        """The cohort's launches, one a shard: ``(first slot, slots,
        pipeline, step)``; ``step(batch)`` advances those slots (batch
        rows) in place and returns their BatchOut. ``feats(device)`` gives
        the session's (edge_feats, node_feats) there. ``scratch``: step a
        copy of the tables (``peek``)."""
        ef, nf = feats(self.device)
        tables = self.state
        if scratch:
            tables = mailbox.VertexState(*(t.clone() for t in tables))

        def step(batch):
            return self.pipeline.batched_step(self.params, self.aux, tables,
                                              batch, ef, nf)

        return [(0, self.capacity, self.pipeline, step)]

    def finite_slots(self) -> torch.Tensor:
        """``(capacity,)`` bool on the device, True where every floating
        table of the slot's V rows is finite. Reduces over the first
        ``capacity * V`` rows: the scratch row after them is not any
        tenant's."""
        cap, V = self.capacity, self.cfg.n_nodes
        flags = torch.ones((cap,), dtype=torch.bool, device=self.device)
        for leaf in self.state:
            if leaf.dtype.is_floating_point:
                flags &= torch.isfinite(
                    leaf[:cap * V].reshape(cap, -1)).all(dim=1)
        return flags

    def _target_capacity(self, n: int) -> int:
        """Slots for ``n`` tenants: ``n``, or the reserve's class."""
        return n if self.reserve is None else self.reserve.capacity_for(n)

    def _capacity_for(self, n: int) -> int:
        """Slots to lay out for ``n`` tenants; their table rows must be
        addressable by the kernels' int32 ids."""
        cap = self._target_capacity(n)
        V = self.cfg.n_nodes
        if cap * (V + 1) >= 2 ** 31:
            raise ValueError(
                f"a cohort of {cap} slots of {V} vertices needs "
                f"{cap * (V + 1)} table rows; the kernels' int32 ids "
                "address fewer than 2**31")
        return cap

    def _fit(self, states: list) -> None:
        """Lay the tables out anew for ``states`` (the tenants' rows, in
        slot order), padded with init-state slots to the target capacity."""
        n = len(states)
        cap = self._capacity_for(n)
        init = self.pipeline.init_state()
        self.state = mailbox.stack_states(states + [init] * (cap - n), init)
        self.capacity = cap

    def _empty(self) -> None:
        """Drop the tables (the last tenant left)."""
        self.state, self.capacity = None, 0

    def ensure_capacity(self) -> None:
        """Lay out the reserve capacity with no tenant (a prewarmed lane)."""
        if self.capacity == 0:
            self._fit([])

    def add(self, tid: str) -> bool:
        """Attach a tenant. True when the tables were laid out anew (the
        round's layout must be rebuilt); False when a spare slot took it."""
        n = self.size
        if self.reserve is not None and self.capacity > n:
            # a spare slot freed by a detach holds the departed rows
            self.write_slot(n, self.pipeline.init_state())
            self.tids.append(tid)
            return False
        self._capacity_for(n + 1)
        states = [self.read_slot(i) for i in range(n)] + [
            self.pipeline.init_state()]
        self.tids.append(tid)
        self._fit(states)
        return True

    def remove(self, tid: str) -> bool:
        """Release the tenant's slot. True when the tables were laid out
        anew. With a reserve the last tenant's rows move into the hole and
        the freed slot stays, idle; without one the tables shrink to the
        remaining tenants (and are dropped with the last)."""
        i = self.tids.index(tid)
        if self.reserve is not None:
            last = len(self.tids) - 1
            if i != last:
                self.write_slot(i, self.read_slot(last))
                self.tids[i] = self.tids[last]
            self.tids.pop()
            return False
        keep = [self.read_slot(j) for j in range(self.size) if j != i]
        self.tids.pop(i)
        if not self.tids:
            self._empty()
        else:
            self._fit(keep)
        return True


class SessionManager:
    """Batched multi-tenant serving over the pipeline registry.

    ::

        mgr = SessionManager(params, edge_feats, model=cfg)
        a = mgr.add_tenant()                        # the base variant
        b = mgr.add_tenant("sat+lut+np4+reservoir")  # same params
        mgr.register_params("teacher-v1", teacher_params)
        c = mgr.add_tenant("teacher", params="teacher-v1")  # own weights
        outs = mgr.step({a: b1, b: b2, c: b3})       # {tid: BatchOut}
        mgr.state_of(a)                              # a's VertexState

    Tenants on the default set share the session's attention and encoder
    (one set cannot drive two parameter trees); a tenant on a named set
    may serve any registry variant.
    """

    def __init__(self, params: dict, edge_feats, node_feats=None, *,
                 model: tgn.TGNConfig | None = None, variant=None,
                 use_kernels=False, coalesce: bool = True, reserve=None,
                 obs: MetricsRegistry | None = None, device=None, **dims):
        if model is None:
            if variant is None:
                raise TypeError("pass model=TGNConfig or variant= + dims")
            model = pl.variant_config(variant, **dims)
        elif variant is not None or dims:
            raise TypeError("model= is exclusive with variant=/dims")
        if reserve is True:          # the default ladder
            from repro_torch.serving.admission import CapacityLadder
            reserve = CapacityLadder()
        #: capacity-class policy (``admission.CapacityLadder`` or anything
        #: with ``capacity_for(n)``), or None: exact-size cohorts
        self.reserve = reserve
        self.base_cfg = model
        self.use_kernels = use_kernels
        self.coalesce = coalesce
        self.device = resolve_device(device)
        self.param_store = ParamStore(params, place=self._place_params)
        self.params = self.param_store.get(DEFAULT_PARAMS)
        self.edge_feats = torch.as_tensor(
            edge_feats, dtype=torch.float32, device=self.device).contiguous()
        if (self.edge_feats.ndim != 2
                or self.edge_feats.shape[1] != model.f_edge):
            raise ValueError(f"edge_feats must be (n, {model.f_edge}), "
                             f"got {tuple(self.edge_feats.shape)}")
        # static node features, (n_nodes, f_feat) when the model has them
        want = (model.n_nodes, model.f_feat)
        self.node_feats = None
        if node_feats is not None or model.f_feat > 0:
            if node_feats is None:
                raise ValueError(f"node_feats must be {want}, got None")
            self.node_feats = torch.as_tensor(
                node_feats, dtype=torch.float32,
                device=self.device).contiguous()
            if tuple(self.node_feats.shape) != want:
                raise ValueError(f"node_feats must be {want}, got "
                                 f"{tuple(self.node_feats.shape)}")
        # keyed by (cfg, resolved tier, param-set name)
        self._cohorts: dict[tuple, _Cohort] = {}
        self._tenant_cohort: dict[str, _Cohort] = {}
        self._next_id = 0
        self.metrics: list[dict] = []
        self._coalesced: pl.CoalescedRound | None = None
        self._lanes: list = []
        self._stager: _HostStager | None = None
        self._drained: tuple[int, float] | None = None   # summary() cache
        #: what the last add_tenant/remove_tenant did to the layout
        self.last_admission: dict | None = None
        self._tenant_stats: dict[str, dict] = {}
        #: the fleet's metrics registry: round counters and the layout
        #: gauges (``compile_counters``)
        self.obs = obs if obs is not None else MetricsRegistry()
        self._obs_rounds = 0     # round walls already fed to registry/SLO
        #: ``() -> {tid: queued rows}`` of a serving front end, or None
        self.queue_depths = None
        #: sampled round tracer (``obs.RoundTracer``) or None
        self.tracer = None
        #: per-tenant SLO burn tracker (``obs.SLOTracker``) or None
        self.slo = None
        #: armed fault plan (``faults.FaultInjector``) or None
        self._faults = None
        #: supervising ``guard.FleetGuard`` (set by its constructor) or None
        self.guard = None
        #: tenants whose batches are dropped and whose slots run idle
        self._quarantined: set[str] = set()

    # -- observability and fault hooks -----------------------------------
    def set_tracer(self, tracer) -> None:
        """Attach a sampled round tracer (``obs.RoundTracer``); ``None``
        detaches. Spans and the device fences happen on sampled rounds
        only; every other round issues no synchronize."""
        self.tracer = tracer

    def set_slo(self, target_ms: float, objective: float = 0.99,
                source: str = "round"):
        """Arm per-tenant SLO burn accounting (``obs.SLOTracker``), shown
        in ``tenant_stats()[tid]["slo"]``. ``source``: ``"round"`` (round
        walls, fed by ``summary()``) or ``"event"`` (a front end's
        per-event latencies)."""
        from repro_torch.obs import SLOTracker
        self.slo = SLOTracker(target_ms, objective=objective, source=source)
        return self.slo

    def set_faults(self, injector) -> None:
        """Arm (``None``: disarm) a deterministic fault plan
        (``faults.FaultInjector``), for chaos runs only."""
        self._faults = injector

    # -- quarantine (the guard's isolation primitive) ------------------
    def quarantine(self, tid: str) -> None:
        """Stop serving ``tid`` without detaching it: its batches are
        dropped from every round, so its slot runs all-``valid=False``
        rows (no change to its state or its cohort-mates'), with no
        relayout."""
        if tid not in self._tenant_cohort:
            raise KeyError(f"unknown tenant {tid!r}")
        self._quarantined.add(tid)
        self.obs.gauge("guard.quarantined_now").set(len(self._quarantined))

    def unquarantine(self, tid: str) -> None:
        self._quarantined.discard(tid)
        self.obs.gauge("guard.quarantined_now").set(len(self._quarantined))

    def is_quarantined(self, tid: str) -> bool:
        return tid in self._quarantined

    @property
    def quarantined(self) -> frozenset:
        return frozenset(self._quarantined)

    def guarded_step(self, batches: Mapping) -> dict:
        """``step`` through the attached ``FleetGuard`` (health checks,
        quarantine, restores, tier degradation), else ``step``. ``run``
        and the front end's pump call this."""
        if self.guard is not None:
            return self.guard.step(batches)
        return self.step(batches)

    def _invalidate_layout(self) -> None:
        """The fleet's layout changed: the next round builds a new one."""
        self._coalesced = None
        self.obs.gauge("compile.round_traces").set(0)
        self.obs.gauge("compile.round_calls").set(0)

    # -- tenant lifecycle ----------------------------------------------
    def _place_params(self, params: dict) -> dict:
        return to_device_tree(params, self.device)

    def _feats(self, device) -> tuple:
        """The (edge_feats, node_feats) stores on ``device``."""
        return self.edge_feats, self.node_feats

    def register_params(self, name: str, params: dict) -> str:
        """Register a named parameter set (placed on the device, immutable)
        for tenants to serve on (``add_tenant(..., params=name)``). Leaves
        the fleet's layout alone. Returns ``name``."""
        self.param_store.register(name, params)
        return name

    def _make_cohort(self, cfg: tgn.TGNConfig, use_kernels,
                     param_set: str = DEFAULT_PARAMS) -> _Cohort:
        return _Cohort(cfg, use_kernels, self.param_store.get(param_set),
                       self.device, reserve=self.reserve,
                       param_set=param_set)

    def _tenant_cfg(self, variant, reservoir_tau,
                    param_set: str = DEFAULT_PARAMS) -> tgn.TGNConfig:
        base = self.base_cfg
        if variant is None:
            cfg = base
        else:
            v = pl.resolve_variant(variant)
            if (v.attention, v.encoder) != (base.attention, base.encoder):
                if param_set == DEFAULT_PARAMS:
                    raise ValueError(
                        f"tenant variant {pl.variant_name(v)!r} needs "
                        f"{v.attention}+{v.encoder} parameters but this "
                        f"session shares {base.attention}+{base.encoder} "
                        "parameters; prune_k and sampler may vary per "
                        "tenant, the parameterized axes may not — unless "
                        "the tenant brings its own weights "
                        "(register_params + add_tenant(..., params=name))")
                # a named set brings its own weights; the table and feature
                # dims stay the session's
                cfg = base.replace(attention=v.attention, encoder=v.encoder,
                                   prune_k=v.prune_k, sampler=v.sampler)
            else:
                cfg = base.replace(prune_k=v.prune_k, sampler=v.sampler)
        if reservoir_tau is not None:
            cfg = cfg.replace(reservoir_tau=reservoir_tau)
        return cfg

    def _resolve_lane(self, variant, reservoir_tau, use_kernels,
                      params) -> tuple:
        """An admission request's lane key ``(cfg, tier, param-set name)``,
        the binding checked before anything in the fleet changes."""
        pname = DEFAULT_PARAMS if params is None else params
        self.param_store.get(pname)          # unknown set: reject here
        cfg = self._tenant_cfg(variant, reservoir_tau, pname)
        self.param_store.check_binding(pname, cfg)
        tier = stages.resolved_tier(
            cfg, self.use_kernels if use_kernels is None else use_kernels)
        return cfg, tier, pname

    def add_tenant(self, variant=None, *, name: str | None = None,
                   reservoir_tau: float | None = None,
                   use_kernels=None, params: str | None = None) -> str:
        """Register a tenant stream; returns its id.

        ``variant``: any registry spec sharing the session's attention and
        encoder (prune budget and sampler may differ), or any variant when
        ``params`` names a registered set. ``use_kernels``: the tenant's
        tier (``"ref"``/``"staged"``/``"fused"`` or a bool; None = the
        session's). Grows the tenant's cohort (a relayout) unless a spare
        slot takes it.
        """
        cfg, tier, pname = self._resolve_lane(variant, reservoir_tau,
                                              use_kernels, params)
        tid = name if name is not None else f"t{self._next_id}"
        self._next_id += 1
        if tid in self._tenant_cohort:
            raise ValueError(f"tenant {tid!r} already exists")
        key = (cfg, tier, pname)
        cohort = self._cohorts.get(key)
        created = cohort is None
        if created:
            cohort = self._cohorts[key] = self._make_cohort(cfg, tier, pname)
        relayout = cohort.add(tid)
        self._tenant_cohort[tid] = cohort
        self._tenant_stats[tid] = {"rounds": 0, "rows": 0,
                                   "last_flush_t": None}
        self.last_admission = {"tid": tid, "relayout": relayout,
                               "new_cohort": created}
        if created or relayout:
            self._invalidate_layout()
        return tid

    def prewarm_cohort(self, variant=None, *,
                       reservoir_tau: float | None = None,
                       use_kernels=None, params: str | None = None) -> None:
        """Lay a lane out with no tenant at its reserve capacity, so that
        its first tenant attaches without a relayout. Needs ``reserve``."""
        if self.reserve is None:
            raise ValueError("prewarm_cohort needs a reserve policy "
                             "(SessionManager(reserve=...)); without spare "
                             "lane slots an empty cohort cannot admit "
                             "anything without a relayout anyway")
        key = self._resolve_lane(variant, reservoir_tau, use_kernels, params)
        if key in self._cohorts:
            return
        cohort = self._cohorts[key] = self._make_cohort(*key)
        cohort.ensure_capacity()
        self._invalidate_layout()

    def remove_tenant(self, tid: str) -> None:
        cohort = self._tenant_cohort[tid]
        # drain the rounds in flight before the slot's rows move
        self.sync()
        self._tenant_cohort.pop(tid)
        self._tenant_stats.pop(tid, None)
        if tid in self._quarantined:
            self.unquarantine(tid)
        relayout = cohort.remove(tid)
        if not cohort.tids and cohort.reserve is None:
            self._cohorts.pop((cohort.cfg, cohort.tier, cohort.param_set))
            relayout = True
        self.last_admission = {"tid": tid, "relayout": relayout,
                               "new_cohort": False}
        if relayout:
            self._invalidate_layout()

    def compile_counters(self) -> dict:
        """``relayouts`` (round layouts built), ``round_traces`` (layout
        builds of the CURRENT round: 1, or 0 before its first round) and
        ``round_calls`` (rounds issued through it), from one registry
        snapshot. An attach or detach that lands in a spare slot changes
        none of them."""
        snap = self.obs.snapshot(prefix="compile.")
        return {"relayouts": int(snap.get("compile.relayouts", 0)),
                "round_traces": int(snap.get("compile.round_traces", 0)),
                "round_calls": int(snap.get("compile.round_calls", 0))}

    @property
    def tenants(self) -> tuple:
        return tuple(self._tenant_cohort)

    def cohort_of(self, tid: str) -> _Cohort:
        return self._tenant_cohort[tid]

    def state_of(self, tid: str) -> mailbox.VertexState:
        """A copy of the tenant's VertexState (V rows) on the session's
        device."""
        cohort = self._tenant_cohort[tid]
        return cohort.read_slot(cohort.tids.index(tid))

    def set_state(self, tid: str, st: mailbox.VertexState) -> None:
        """Write the tenant's rows where its cohort keeps them (a leaf may
        be the pieces ``_Cohort.slot_shardings`` placed)."""
        cohort = self._tenant_cohort[tid]
        cohort.write_slot(cohort.tids.index(tid), st)

    def describe(self) -> dict:
        """Cohort layout: variant -> tenants, capacity, parameter set and
        resolved stages. Cohorts that share a variant name get
        ``@tau=`` / ``@params=`` / ``@<tier>`` suffixes."""
        out, holders = {}, {}
        for c in self._cohorts.values():
            key = base = c.pipeline.variant
            if key in out:
                first = holders[base]
                if c.cfg.reservoir_tau != first.cfg.reservoir_tau:
                    key = f"{base}@tau={c.cfg.reservoir_tau:g}"
                if key in out and c.param_set != first.param_set:
                    key = f"{key}@params={c.param_set}"
                if key in out:
                    key = f"{key}@{c.tier}"
            holders.setdefault(base, c)
            out[key] = {"tenants": tuple(c.tids), "capacity": c.capacity,
                        "param_set": c.param_set, **c.pipeline.describe()}
        return out

    # -- the round -----------------------------------------------------
    def _cohort_round(self, cohort: _Cohort, submitted: dict,
                      scratch: bool = False) -> list:
        """Stack the submitted batches of ``cohort`` (idle slots masked)
        and advance its tables (or, with ``scratch``, a copy) in one
        launch a lane. Returns ``[(first slot, slots, BatchOut), ...]``."""
        B = max(d[0].shape[0] for d in submitted.values())
        devs = [(_pad_dev(submitted[tid], B) if tid in submitted
                 else _idle_dev(B, self.device)) for tid in cohort.tids]
        devs += [_idle_dev(B, self.device)] * (cohort.capacity - len(devs))
        if len(devs) == 1:
            stacked = tuple(x[None] for x in devs[0])
        else:
            stacked = tuple(torch.stack([d[j] for d in devs])
                            for j in range(5))
        return [(lo, n, step(tuple(x[lo:lo + n] for x in stacked)))
                for lo, n, _pipe, step in cohort.lanes(self._feats,
                                                       scratch=scratch)]

    def _tenant_outs(self, cohort: _Cohort, lane_outs, widths: Mapping,
                     with_state: bool = False) -> dict:
        """``{tid: BatchOut}`` of the tenants in ``widths`` (their own
        batch widths) from a cohort's ``(first slot, slots, BatchOut)``
        lane outputs."""
        outs = {}
        for lo, n, out in lane_outs:
            for i, tid in enumerate(cohort.tids[lo:lo + n]):
                if tid in widths:
                    outs[tid] = self._slice_out(out, i, widths[tid],
                                                cohort.cfg.n_nodes,
                                                with_state)
        return outs

    @staticmethod
    def _slice_out(out: tgn.BatchOut, i: int, b: int, V: int,
                   with_state: bool = False) -> tgn.BatchOut:
        """Slot ``i``'s BatchOut, cut to its own ``b`` rows (the 2B-row
        views are [src rows, dst rows]). ``state`` is None unless
        ``with_state`` (tenants' states are committed in the session)."""
        B = out.emb_src.shape[1]
        dev = out.emb_src.device
        two = slice(None) if b == B else torch.cat(
            [torch.arange(b, device=dev), B + torch.arange(b, device=dev)])
        return tgn.BatchOut(
            state=(mailbox.tenant_view(out.state, i, V) if with_state
                   else None),
            emb_src=out.emb_src[i, :b], emb_dst=out.emb_dst[i, :b],
            attn_logits=out.attn_logits[i][two],
            nbr_valid=out.nbr_valid[i][two], nbr_dt=out.nbr_dt[i][two])

    def _ensure_layout(self, width: int) -> pl.CoalescedRound:
        if self._coalesced is None:
            #: the round's lanes, aligned with its segments
            self._lanes = [(c, lo, n, pipe, step)
                           for c in self._cohorts.values()
                           for lo, n, pipe, step in c.lanes(self._feats)]
            self._coalesced = pl.CoalescedRound(
                ((pipe, step, n) for _c, _lo, n, pipe, step in self._lanes),
                obs=self.obs)
            self.obs.counter("compile.relayouts").inc()
        if self._stager is None or self._stager.rows != self._coalesced.rows:
            if self._stager is not None:
                self._stager.drain()
            self._stager = _HostStager(self._coalesced.rows, width,
                                       self.device)
        self._stager.ensure_width(width)
        return self._coalesced

    def _coalesced_round(self, batches: Mapping,
                         trace=None) -> tuple[dict, object]:
        """Stage every submitted batch into the super-batch (one copy),
        issue every cohort's step in one call, and commit in place.
        Returns ``(outs, pending edge count)``.

        ``trace`` is the tracer on a sampled round, else None: then the
        ``stage`` and ``launch`` host spans are recorded and the ``h2d``
        span waits for the super-batch's copy (an event recorded after
        it). Every fence is inside the ``trace`` gate."""
        host = {tid: _as_host_tuple(b) for tid, b in batches.items()}
        width = max(h[0].shape[0] for h in host.values())
        launch = self._ensure_layout(width)
        offsets, lo = {}, 0
        for c in self._cohorts.values():
            offsets[id(c)] = lo
            lo += c.capacity
        rows, widths = {}, {}
        for tid, h in host.items():
            c = self._tenant_cohort[tid]
            rows[offsets[id(c)] + c.tids.index(tid)] = h
            widths[id(c)] = max(widths.get(id(c), 1), h[0].shape[0])
        if trace is not None:
            t_stage = trace.clock()
        superbatch = self._stager.stage(rows)
        if trace is not None:
            copied = _mark(self.device)
            t_launch = trace.clock()
            trace.add("stage", t_stage, t_launch, cat="host",
                      rows=len(rows), width=width)
        # each segment steps at its cohort's widest batch (an idle cohort
        # runs a width-1 masked row), the width its own launch would take
        outs_t, edges = launch(superbatch, widths=tuple(
            widths.get(id(c), 1) for c, *_ in self._lanes))
        self._stager.note_consumer()
        if trace is not None:
            trace.add("launch", t_launch, trace.clock(), cat="host",
                      lanes=len(self._lanes))
            _fence(copied)
            trace.add("h2d", t_stage, trace.clock(), cat="device",
                      rows=len(rows))
        outs: dict[str, tgn.BatchOut] = {}
        mine = {tid: h[0].shape[0] for tid, h in host.items()}
        for (c, lo, n, _p, _s), out in zip(self._lanes, outs_t):
            outs.update(self._tenant_outs(c, [(lo, n, out)], mine))
        return outs, edges

    def _device_staged(self, batches: Mapping) -> bool:
        """A one-tenant fleet fed a batch already on the device (the
        engine's prefetched copy): it launches through the per-cohort path
        instead of a round trip through the host stager."""
        if len(batches) != 1 or len(self._tenant_cohort) != 1:
            return False
        (b,) = batches.values()
        return (isinstance(b, tuple) and not isinstance(b, EdgeBatch)
                and len(b) == 5
                and all(x is None or isinstance(x, torch.Tensor) for x in b))

    def _percohort_round(self, batches: Mapping) -> tuple[dict, object, int]:
        """One launch a cohort with a submitted batch, each cohort's
        batches stacked on the device (``coalesce=False``, the baseline;
        its trajectories equal the coalesced round's bit for bit)."""
        outs: dict[str, tgn.BatchOut] = {}
        launches, edges = 0, 0
        for cohort in self._cohorts.values():
            submitted = {tid: _as_device_tuple(batches[tid], self.device)
                         for tid in cohort.tids if tid in batches}
            if not submitted:
                continue
            lane_outs = self._cohort_round(cohort, submitted)
            launches += 1
            outs.update(self._tenant_outs(
                cohort, lane_outs,
                {t: d[0].shape[0] for t, d in submitted.items()}))
            for d in submitted.values():
                edges = edges + d[4].sum()
        return outs, edges, launches

    def step(self, batches: Mapping[str, EdgeBatch | tuple]) -> dict:
        """Advance every tenant with a submitted batch. Coalesced (the
        default), the round is one call over every cohort (idle members
        masked) fed by one copy; with ``coalesce=False`` each cohort with
        a submitted batch launches on its own. Returns ``{tid: BatchOut}``
        for the submitted tenants, ``state=None``: states are committed in
        place (``state_of``). Nothing here waits for the device."""
        unknown = set(batches) - set(self._tenant_cohort)
        if unknown:
            raise KeyError(f"unknown tenants {sorted(unknown)}; "
                           f"registered: {sorted(self._tenant_cohort)}")
        if self._faults is not None:
            batches = self._faults.on_round(self, batches)
        if self._quarantined:
            # dropped: the slot runs idle rows, its state unchanged
            batches = {t: b for t, b in batches.items()
                       if t not in self._quarantined}
        trace = None
        if self.tracer is not None and batches:
            trace = self.tracer if self.tracer.sample_round() else None
        t0 = time.perf_counter()
        if self._faults is not None:
            self._faults.before_launch(self)     # may raise KernelFault
        if not batches:
            outs, edges, launches = {}, 0, 0
        elif self.coalesce and not self._device_staged(batches):
            outs, edges = self._coalesced_round(batches, trace=trace)
            launches = 1
        else:
            outs, edges, launches = self._percohort_round(batches)
        dt = time.perf_counter() - t0
        self._drained = None
        self.metrics.append({
            "t0": t0, "latency_s": dt, "edges": edges,
            "launches": launches, "tenants_active": len(outs),
            "tids": tuple(batches)})
        self.obs.counter("session.rounds").inc()
        self.obs.counter("session.launches").inc(launches)
        for tid, b in batches.items():
            ts = self._tenant_stats[tid]
            ts["rounds"] += 1
            ts["rows"] += int(_fields(b)[0].shape[0])
            ts["last_flush_t"] = t0
        if trace is not None:
            # sampled rounds only: wait for this round's commits
            t_drain = trace.clock()
            _fence(_mark(self.device))
            trace.add("drain", t_drain, trace.clock(), cat="device",
                      round=len(self.metrics) - 1)
        return outs

    def sync(self) -> None:
        """Drain the fleet: wait until every issued round has landed."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self._stager is not None:
            self._stager.drain()

    def peek(self, tid: str, batch) -> tgn.BatchOut:
        """The tenant's step output WITHOUT committing any state (a timing
        and what-if hook; other slots of its cohort idle): the cohort's
        ``batched_step`` on a copy of its tables, so its time includes one
        device copy of them. ``state`` is the tenant's state after the
        step."""
        cohort = self._tenant_cohort[tid]
        dev = _as_device_tuple(batch, self.device)
        lane_outs = self._cohort_round(cohort, {tid: dev}, scratch=True)
        return self._tenant_outs(cohort, lane_outs, {tid: dev[0].shape[0]},
                                 with_state=True)[tid]

    # -- stream driving ------------------------------------------------
    def run(self, streams: Mapping[str, Iterable]):
        """Drive tenant streams round-robin until all are exhausted;
        yields ``(batches, outs)`` a round. A tenant whose stream has
        ended idles."""
        its = {tid: iter(s) for tid, s in streams.items()}
        while its:
            batches = {}
            for tid in list(its):
                try:
                    batches[tid] = next(its[tid])
                except StopIteration:
                    del its[tid]
            if not batches:
                return
            yield batches, self.guarded_step(batches)

    def tenant_stats(self) -> dict:
        """``{tid: {queue_depth, rounds, rows, last_flush_t, quarantined[,
        slo][, guard]}}``: the front end's queued rows (0 without one),
        rounds joined, rows submitted (padding included), the host clock
        of the last round joined, the quarantine flag, and the tenant's
        SLO burn (every tenant, when ``set_slo`` armed one) and guard
        record (with a guard)."""
        qd = dict(self.queue_depths()) if self.queue_depths else {}
        slo, guard = self.slo, self.guard
        return {tid: {"queue_depth": int(qd.get(tid, 0)), **st,
                      "quarantined": tid in self._quarantined,
                      **({"slo": slo.tenant(tid)} if slo is not None
                         else {}),
                      **({"guard": guard.tenant_view(tid)}
                         if guard is not None else {})}
                for tid, st in self._tenant_stats.items()}

    def summary(self) -> dict:
        """Round metrics over every round after the first, and
        ``per_tenant`` (``tenant_stats``). Steps do not wait, so a round's
        wall is the time to the next round's start (the last absorbs the
        final ``sync()``), and the pending edge counts are resolved here.
        Call right after the last round."""
        if len(self.metrics) < 2:
            return {}
        if self._drained is None or self._drained[0] != len(self.metrics):
            self.sync()
            self._drained = (len(self.metrics), time.perf_counter())
        t0s = [m["t0"] for m in self.metrics] + [self._drained[1]]
        walls = np.diff(np.array(t0s))[1:]
        wall_h = Histogram("session.round_wall_s")
        for w in walls:
            wall_h.record(w)
        reg_h = self.obs.histogram("session.round_wall_s")
        slo = self.slo if (self.slo is not None
                           and self.slo.source == "round") else None
        for i in range(self._obs_rounds, len(walls)):
            reg_h.record(walls[i])
            if slo is not None:
                for tid in self.metrics[i + 1].get("tids", ()):
                    if tid in self._tenant_cohort:
                        slo.observe(tid, float(walls[i]))
        self._obs_rounds = len(walls)
        edges = sum(int(m["edges"]) for m in self.metrics[1:])
        return {
            "rounds": len(walls),
            "tenants": len(self._tenant_cohort),
            "cohorts": len(self._cohorts),
            # max: tail rounds of uneven streams mask whole cohorts
            "launches_per_round": max(m["launches"]
                                      for m in self.metrics[1:]),
            "mean_round_ms": (wall_h.mean() or 0.0) * 1e3,
            "p99_round_ms": (wall_h.quantile(0.99) or 0.0) * 1e3,
            "throughput_eps": (float(edges / wall_h.total)
                               if wall_h.total > 0 else 0.0),
            "per_tenant": self.tenant_stats(),
        }
