"""Online serving front-end: async ingestion + deadline batching.

Port of ``repro.serving.frontend``: the same batcher, protocol and wire
transport over the port's ``SessionManager``. Flushed batches stay host
numpy columns; the session's ``_HostStager`` copies a round's batches to
the device in one transfer.

Layered over ``SessionManager`` (ideally reserve-enabled — see
``serving/admission.py``) this module turns per-tenant edge EVENTS into
the per-round edge BATCHES the coalesced launch consumes:

``DeadlineBatcher``
    pure, clock-injected micro-batching. Events enqueue into bounded
    per-tenant FIFO queues; a round flushes when any tenant has
    ``max_rows`` pending OR the oldest pending event has waited
    ``max_wait_s``, whichever first. Full queues reject with
    ``RetryAfter`` (bounded memory, never silent drops). Flushed batches
    are padded (repeat-last-row, ``valid=False``) to a ``pad_quantum``
    multiple so the round's widths vector — and with it the round's
    shapes — stays stable under jittery arrival rates.

``ServingFrontend``
    the serving shell: a synchronous ``pump()`` core (testable without an
    event loop) driving ``SessionManager.step`` plus an asyncio loop
    (``start``/``stop``) and a request dispatcher (``handle``) speaking a
    dict protocol — op "ingest" | "attach" | "detach" | "stats" |
    "metrics" | "flush". Live attach/detach land mid-stream on the
    reserve fast path: no relayout, surviving tenants' trajectories
    bitwise-unchanged. Event latencies stream into the fleet's
    ``obs.MetricsRegistry``; ``metrics`` returns its lock-consistent
    snapshot plus per-tenant SLO burn (docs/OBSERVABILITY.md).

``serve_jsonl``
    the stdlib wire transport: newline-delimited JSON over
    ``asyncio.start_server``, one request dict per line, one response
    dict per line. ``launch/serve.py --listen HOST:PORT`` boots it.

The batcher never touches the device: it hands ``EdgeBatch`` dicts to
``SessionManager.step``, which stages through the in-place host ring
buffers as always. A fake ``clock`` makes every deadline path
deterministic under test.
"""
from __future__ import annotations

import asyncio
import json
import math
import time
from collections import deque
from dataclasses import dataclass

import numpy as np

from repro_torch.data.stream import EdgeBatch


class RetryAfter(Exception):
    """A TRANSIENT ingest rejection: retry later, nothing is wrong with
    the request itself.

    Two sources: the tenant's bounded queue is full (``reason=
    "queue_full"`` — classic backpressure), or the tenant is quarantined
    by the FleetGuard and its auto-restore is pending (``reason=
    "quarantined"``). Carries the suggested retry delay; the transport
    maps it to a structured ``{"ok": false, "error": "retry_after",
    "transient": true, ...}`` response (HTTP would say 429/503) instead
    of growing the queue without bound. Permanent rejections —
    malformed events, unknown tenants — are ``invalid_request`` /
    ``unknown_tenant`` with ``"transient": false`` instead.
    """

    def __init__(self, tid: str, seconds: float, depth: int,
                 reason: str = "queue_full", last_seq=None):
        super().__init__(f"tenant {tid!r} {reason} ({depth} rows); "
                         f"retry after {seconds:.3f}s")
        self.tid = tid
        self.seconds = seconds
        self.depth = depth
        self.reason = reason
        #: with a journal armed, the client's highest accepted seq — a
        #: reconnecting client resumes after it without a stats
        #: round-trip (docs/SERVING.md retry contract)
        self.last_seq = last_seq


class DuplicateEvent(Exception):
    """An ingest retry the journal's dedup window already accepted.

    NOT an error: the event is durably journaled (and possibly already
    applied), so the transport ACKS it — ``{"ok": true, "dedup": true}``
    — and never re-enqueues. This is the server half of the exactly-once
    contract: clients retry at-least-once, the dedup window makes the
    retries idempotent (docs/ROBUSTNESS.md)."""

    def __init__(self, tid: str, client_id: str, seq: int):
        super().__init__(f"tenant {tid!r} client {client_id!r} seq {seq} "
                         "already accepted")
        self.tid = tid
        self.client_id = client_id
        self.seq = seq


@dataclass(frozen=True)
class FrontendConfig:
    """Knobs of the deadline batcher + backpressure contract."""
    max_wait_s: float = 0.010   #: flush when the oldest event is this old
    max_rows: int = 128         #: flush when any tenant has this many rows
    queue_rows: int = 1024      #: per-tenant bound; beyond it -> RetryAfter
    retry_after_s: float = 0.05  #: suggested client backoff on rejection
    #: pad flushed batches (repeat-last, ``valid=False``) to a multiple of
    #: this, so the round sees a stable widths vector. 0 = exact (every
    #: flush size is its own round shape).
    pad_quantum: int = 0


def _pad_rows(cols: tuple, quantum: int) -> tuple:
    """Repeat-last-row pad ``(src, dst, eid, ts, valid, neg)`` columns up
    to a ``quantum`` multiple, padding rows ``valid=False`` — numerically
    a masked no-op, exactly the offline stream's padding convention."""
    n = len(cols[0])
    if quantum <= 0 or n % quantum == 0:
        return cols
    b = ((n + quantum - 1) // quantum) * quantum
    out = []
    for i, c in enumerate(cols):
        reps = np.repeat(c[-1:], b - n, axis=0)
        if i == 4:                       # the valid mask
            reps = np.zeros(b - n, dtype=bool)
        out.append(np.concatenate([c, reps], axis=0))
    return tuple(out)


class DeadlineBatcher:
    """Bounded per-tenant event queues with deadline/size flush triggers.

    Pure host-side bookkeeping — inject a fake ``clock`` to test every
    trigger deterministically. Each pending event is one edge
    ``(src, dst, eid, ts, neg_dst)`` plus its arrival wall time.
    """

    def __init__(self, cfg: FrontendConfig, clock=time.monotonic):
        self.cfg = cfg
        self.clock = clock
        self._q: dict[str, deque] = {}
        self.rejected = 0       #: events refused with RetryAfter
        self.accepted = 0       #: events enqueued
        self.flushes = 0        #: rounds handed out by take()

    def add_tenant(self, tid: str) -> None:
        self._q.setdefault(tid, deque())

    def drop_tenant(self, tid: str) -> deque:
        """Detach bookkeeping; returns (possibly non-empty) leftovers."""
        return self._q.pop(tid, deque())

    def check_capacity(self, tid: str) -> None:
        """Raise ``RetryAfter`` if the tenant's bounded queue is full.
        The frontend pre-checks this BEFORE a write-ahead journal append
        — a journaled-then-rejected event would dedup the client's retry
        into a silently lost event."""
        q = self._q[tid]
        if len(q) >= self.cfg.queue_rows:
            self.rejected += 1
            raise RetryAfter(tid, self.cfg.retry_after_s, len(q))

    def submit(self, tid: str, src: int, dst: int, eid: int, ts: float,
               neg_dst: int = 0) -> int:
        """Enqueue one edge event; returns the tenant's queue depth.
        Raises ``RetryAfter`` when the bounded queue is full."""
        self.check_capacity(tid)
        q = self._q[tid]
        q.append((int(src), int(dst), int(eid), float(ts), int(neg_dst),
                  self.clock()))
        self.accepted += 1
        return len(q)

    def depths(self) -> dict:
        """{tid: pending rows} — the manager's queue-depth provider."""
        return {tid: len(q) for tid, q in self._q.items()}

    def oldest(self) -> float | None:
        """Arrival time of the oldest pending event, None when idle."""
        arrivals = [q[0][5] for q in self._q.values() if q]
        return min(arrivals) if arrivals else None

    def due(self, now: float | None = None) -> bool:
        """Should a round flush now? True when any tenant hit
        ``max_rows`` or the oldest pending event aged past
        ``max_wait_s``."""
        if any(len(q) >= self.cfg.max_rows for q in self._q.values()):
            return True
        oldest = self.oldest()
        if oldest is None:
            return False
        now = self.clock() if now is None else now
        return (now - oldest) >= self.cfg.max_wait_s

    def next_deadline(self) -> float | None:
        """Absolute clock time of the pending deadline, None when idle."""
        oldest = self.oldest()
        return None if oldest is None else oldest + self.cfg.max_wait_s

    def take(self) -> tuple:
        """Drain up to ``max_rows`` per tenant into ``EdgeBatch``es
        (leftovers stay queued FIFO for the next round). Tenants with
        nothing pending are omitted — the coalesced round idle-masks
        them. Returns ``(batches, arrivals)``: the round's ``{tid:
        EdgeBatch}`` plus ``{tid: arrival clock times}`` of the drained
        events (per-tenant, so latency accounting and SLO burn can
        attribute each event; padding rows excluded)."""
        batches, arrivals = {}, {}
        for tid, q in self._q.items():
            if not q:
                continue
            rows = [q.popleft() for _ in range(min(len(q),
                                                   self.cfg.max_rows))]
            src, dst, eid, ts, neg, arrival = zip(*rows)
            arrivals[tid] = arrival
            cols = (np.asarray(src, np.int32), np.asarray(dst, np.int32),
                    np.asarray(eid, np.int32), np.asarray(ts, np.float32),
                    np.ones(len(rows), bool), np.asarray(neg, np.int32))
            batches[tid] = EdgeBatch(*_pad_rows(cols, self.cfg.pad_quantum))
        if batches:
            self.flushes += 1
        return batches, arrivals


class ServingFrontend:
    """Deadline-batched online serving over a ``SessionManager``.

    The synchronous core (``submit``/``pump``/``handle``) is complete on
    its own — tests drive it with a fake clock and zero event-loop
    machinery. ``start()``/``stop()`` wrap it in an asyncio task that
    sleeps until the next deadline (or an ingest wake) and pumps.

    ``record_rounds=True`` keeps a log of every flushed ``{tid: batch}``
    mapping — the replay tape the bitwise acceptance test feeds to an
    offline ``SessionManager`` run.
    """

    def __init__(self, mgr, cfg: FrontendConfig | None = None,
                 clock=time.monotonic, record_rounds: bool = False,
                 tracer=None, slo_ms: float | None = None,
                 slo_objective: float = 0.99, journal=None):
        self.mgr = mgr
        #: optional ``EventJournal`` (serving/journal.py). Armed, every
        #: accepted ingest is write-ahead journaled BEFORE enqueue and
        #: ``(client_id, seq)`` retries dedup; disarmed, the hot path
        #: pays one attribute test.
        self.journal = journal
        self.dedups = 0     #: retried ingests absorbed by the window
        self.cfg = cfg or FrontendConfig()
        self.clock = clock
        self.batcher = DeadlineBatcher(self.cfg, clock)
        for tid in mgr.tenants:
            self.batcher.add_tenant(tid)
        # one source of truth: summary()["per_tenant"].queue_depth reads
        # the live frontend queues
        mgr.queue_depths = self.batcher.depths
        #: the fleet registry (shared with the manager): one consistent
        #: snapshot backs both the stats and metrics responses
        self.obs = mgr.obs
        #: per-event queue->flush latency distribution — a bounded-memory
        #: streaming histogram in the fleet registry (was a raw deque
        #: with hand-rolled percentile math)
        self.event_latencies = self.obs.histogram("frontend.event_latency_s")
        if tracer is not None:
            # span coherence needs one clock: ingest spans carry batcher
            # arrival times, so the tracer should share ``clock``
            mgr.set_tracer(tracer)
        if slo_ms is not None:
            mgr.set_slo(slo_ms, slo_objective, source="event")
        elif getattr(mgr, "slo", None) is not None:
            # an SLO armed before the frontend existed: per-event
            # latencies are the observation source once we're online
            mgr.slo.source = "event"
        self.rounds = 0
        self.events = 0
        self.orphaned = 0   #: rows dropped by out-of-band detaches
        self.round_log: list | None = [] if record_rounds else None
        self._task: asyncio.Task | None = None
        self._wake: asyncio.Event | None = None
        self._stopping = False

    # ------------------------------------------------------------- core
    def submit(self, tid: str, src: int, dst: int, eid: int, ts: float,
               neg_dst: int = 0, *, client_id=None, seq=None) -> int:
        """Validate + (journal-armed) write-ahead log + enqueue one
        event. ``(client_id, seq)`` is the client's idempotency stamp:
        a seq the dedup window already accepted raises
        ``DuplicateEvent`` (ack, don't re-enqueue); a journal write
        failure raises ``RetryAfter(reason="journal_io")`` with the seq
        NOT committed, so the client's retry is accepted."""
        if tid not in self.mgr.tenants:
            raise KeyError(f"unknown tenant {tid!r}")
        try:
            if getattr(self.mgr, "is_quarantined", None) is not None \
                    and self.mgr.is_quarantined(tid):
                # transient: the guard's auto-restore is pending —
                # suggest its next-attempt countdown when scheduled
                guard = getattr(self.mgr, "guard", None)
                view = guard.tenant_view(tid) if guard is not None else {}
                after = view.get("next_attempt_in_s")
                raise RetryAfter(tid, (after if after
                                       else self.cfg.retry_after_s),
                                 0, reason="quarantined")
            faults = getattr(self.mgr, "_faults", None)
            if faults is not None:
                # chaos-only wire-corruption hook (gated)
                src, dst, eid, ts, neg_dst = faults.on_ingest(
                    tid, src, dst, eid, ts, neg_dst)
            # ingest validation: corruption past this point would poison
            # the tenant's resident state, so reject at the wire
            ts = float(ts)
            if not math.isfinite(ts):
                raise ValueError(f"non-finite timestamp {ts!r} for "
                                 f"tenant {tid!r}")
            src, dst, eid, neg_dst = (int(src), int(dst), int(eid),
                                      int(neg_dst))
            if min(src, dst, eid, neg_dst) < 0:
                raise ValueError(f"negative id in event ({src}, {dst}, "
                                 f"{eid}, neg {neg_dst}) for tenant "
                                 f"{tid!r}")
            # tenants attached straight through the manager (or an
            # AdmissionController) get their queue on first ingest
            self.batcher.add_tenant(tid)
            if self.journal is not None:
                # write-ahead + exactly-once (gated):
                # dedup query -> capacity pre-check -> WAL append, in
                # that order — a duplicate never re-journals, and an
                # event is only ever on disk once it is guaranteed a
                # queue slot
                if client_id is not None and seq is not None \
                        and self.journal.is_duplicate(tid, client_id,
                                                      seq):
                    self.dedups += 1
                    raise DuplicateEvent(tid, client_id, seq)
                self.batcher.check_capacity(tid)
                torn = None
                if faults is not None:
                    # chaos-only WAL failure hook (gated)
                    torn = faults.on_journal_append(tid)
                self.journal.append_event(tid, src, dst, eid, ts,
                                          neg_dst, client_id=client_id,
                                          seq=seq, torn=torn == "torn")
            depth = self.batcher.submit(tid, src, dst, eid, ts, neg_dst)
        except RetryAfter as e:
            if self.journal is not None and client_id is not None:
                e.last_seq = self.journal.last_seq(tid, client_id)
            raise
        except OSError as e:
            # the WAL append failed: nothing reached disk, the seq was
            # never committed to the dedup window — reject transiently
            # and the client's retry of the SAME seq is accepted
            err = RetryAfter(tid, self.cfg.retry_after_s,
                             self.batcher.depths().get(tid, 0),
                             reason="journal_io")
            if self.journal is not None and client_id is not None:
                err.last_seq = self.journal.last_seq(tid, client_id)
            raise err from e
        self.events += 1
        if self._wake is not None:
            self._wake.set()
        return depth

    def pump(self, now: float | None = None, force: bool = False) -> dict:
        """Flush one round if due (or ``force``). Returns ``{tid:
        BatchOut}`` (empty when nothing flushed)."""
        now = self.clock() if now is None else now
        if not force and not self.batcher.due(now):
            return {}
        # a tenant detached out-of-band (straight through the manager or
        # an AdmissionController, not frontend.detach) leaves an orphaned
        # queue; drop it rather than step() an unknown tenant
        known = set(self.mgr.tenants)
        for tid in [t for t in self.batcher._q if t not in known]:
            self.orphaned += len(self.batcher.drop_tenant(tid))
        tracer = getattr(self.mgr, "tracer", None)
        # peek (not sample_round — the session consumes the round slot):
        # time flush/ingest only when this round will carry spans
        trace = (tracer if tracer is not None and tracer.would_sample()
                 else None)
        if trace is not None:
            t_flush = trace.clock()
        batches, arrivals = self.batcher.take()
        if not batches:
            return {}
        if self.round_log is not None:
            self.round_log.append(batches)
        if self.journal is not None:
            # WAL flush markers (gated), written
            # BEFORE the state transition so replay can rebuild this
            # exact batch boundary. A quarantined tenant's batch is
            # DROPPED by step() — no marker, so its journaled events
            # stay pending and a post-restore replay re-applies them.
            qset = getattr(self.mgr, "quarantined", frozenset())
            for jtid, arr in arrivals.items():
                if jtid in qset:
                    continue
                self.journal.note_flush(jtid, len(arr),
                                        batches[jtid].src.shape[0])
        if trace is not None:
            t_step = trace.clock()
            trace.add("flush", t_flush, t_step, cat="frontend",
                      tenants=len(batches))
            oldest = min(a for arr in arrivals.values() for a in arr)
            # queueing span of the round's oldest event: its arrival on
            # the shared clock -> the moment the round enters the session
            trace.add("ingest", oldest, t_step, cat="frontend",
                      events=sum(len(a) for a in arrivals.values()))
        outs = self.mgr.guarded_step(batches)
        done = self.clock()
        slo = getattr(self.mgr, "slo", None)
        if slo is not None and slo.source != "event":
            slo = None
        for tid, arr in arrivals.items():
            for a in arr:
                lat = done - a
                self.event_latencies.record(lat)
                if slo is not None:
                    slo.observe(tid, lat)
        self.rounds += 1
        return outs

    def attach(self, variant=None, *, name: str | None = None,
               use_kernels=None, params: str | None = None) -> str:
        tid = self.mgr.add_tenant(variant, name=name,
                                  use_kernels=use_kernels, params=params)
        self.batcher.add_tenant(tid)
        return tid

    def detach(self, tid: str) -> None:
        """Flush the tenant's pending rows (so no accepted event is
        silently dropped), then release its lane slot."""
        if self.batcher.depths().get(tid):
            self.pump(force=True)
        self.batcher.drop_tenant(tid)
        self.mgr.remove_tenant(tid)

    def stats(self) -> dict:
        lat = self.event_latencies
        return {
            "tenants": list(self.mgr.tenants),
            "rounds": self.rounds,
            "events": self.events,
            "accepted": self.batcher.accepted,
            "rejected": self.batcher.rejected,
            "flushes": self.batcher.flushes,
            "queue_depths": self.batcher.depths(),
            "latency_p50_s": lat.quantile(0.50),    # None until an event
            "latency_p99_s": lat.quantile(0.99),
            # one atomic registry read (compile_counters snapshots) — an
            # AdmissionController.stats() in the same response reads the
            # identical view, never a mid-round disagreement
            "compile": self.mgr.compile_counters(),
            **({"guard": self.mgr.guard.snapshot()}
               if getattr(self.mgr, "guard", None) is not None else {}),
            **({"journal": {**self.journal.stats(),
                            "dedups": self.dedups}}
               if self.journal is not None else {}),
        }

    def metrics_snapshot(self) -> dict:
        """The ``metrics`` wire-op payload: one lock-consistent registry
        snapshot plus per-tenant SLO burn (every resident tenant), the
        tracer's span tallies, and the FleetGuard's recovery counters
        (quarantines/restores/degradations/evictions + the live
        quarantine set) when those are armed."""
        out = {"registry": self.obs.snapshot(),
               "compile": self.mgr.compile_counters()}
        slo = getattr(self.mgr, "slo", None)
        if slo is not None:
            out["slo"] = {tid: slo.tenant(tid) for tid in self.mgr.tenants}
        tracer = getattr(self.mgr, "tracer", None)
        if tracer is not None:
            out["trace"] = tracer.summary()
        guard = getattr(self.mgr, "guard", None)
        if guard is not None:
            out["guard"] = guard.snapshot()
        return out

    # -------------------------------------------------------- dispatcher
    def handle(self, req: dict) -> dict:
        """One request dict -> one response dict (the wire protocol).

        ops: ``ingest`` (tid, src, dst, eid, ts[, neg_dst]
        [, client_id, seq — the exactly-once idempotency stamp]) |
        ``attach`` ([variant][, name][, use_kernels][, params]) |
        ``detach`` (tid) | ``stats`` | ``metrics`` (registry snapshot +
        SLO burn + trace tallies) | ``flush`` (force a round now).

        ``attach.params`` names a parameter set already registered via
        ``SessionManager.register_params``; an unknown name is rejected
        with ``invalid_request`` BEFORE any lane state changes — the
        wire protocol carries names, never weights.

        Every error response carries ``"transient"``: ``retry_after``
        (backpressure, quarantine) means try again later; everything
        else (malformed request, unknown tenant/op) is permanent —
        resubmitting the same request cannot succeed. A malformed
        request NEVER raises out of here: the dispatcher is the
        transport's crash barrier.
        """
        if not isinstance(req, dict):
            return {"ok": False, "error": "invalid_request",
                    "transient": False,
                    "detail": f"request must be a JSON object, got "
                              f"{type(req).__name__}"}
        try:
            op = req.get("op")
            if op == "ingest":
                missing = [k for k in ("tid", "src", "dst", "ts")
                           if k not in req]
                if missing:
                    return {"ok": False, "error": "invalid_request",
                            "transient": False,
                            "detail": f"ingest missing fields {missing}"}
                depth = self.submit(req["tid"], req["src"], req["dst"],
                                    req.get("eid", 0), req["ts"],
                                    req.get("neg_dst", 0),
                                    client_id=req.get("client_id"),
                                    seq=req.get("seq"))
                return {"ok": True, "queued": depth}
            if op == "attach":
                tid = self.attach(req.get("variant"),
                                  name=req.get("name"),
                                  use_kernels=req.get("use_kernels"),
                                  params=req.get("params"))
                return {"ok": True, "tid": tid,
                        "admission": dict(self.mgr.last_admission or {})}
            if op == "detach":
                self.detach(req["tid"])
                return {"ok": True,
                        "admission": dict(self.mgr.last_admission or {})}
            if op == "stats":
                return {"ok": True, "stats": self.stats()}
            if op == "metrics":
                return {"ok": True, "metrics": self.metrics_snapshot()}
            if op == "flush":
                outs = self.pump(force=True)
                return {"ok": True, "flushed": sorted(outs)}
            return {"ok": False, "error": "unknown_op", "op": op,
                    "transient": False}
        except DuplicateEvent as e:
            # exactly-once ack: the event is already journaled (and
            # possibly applied) — acknowledge, never re-enqueue
            return {"ok": True, "dedup": True, "tid": e.tid,
                    "client_id": e.client_id, "seq": e.seq}
        except RetryAfter as e:
            resp = {"ok": False, "error": "retry_after",
                    "transient": True, "reason": e.reason,
                    "retry_after_s": e.seconds, "tid": e.tid,
                    "depth": e.depth}
            if e.last_seq is not None:
                # resume hint: the client's highest accepted seq
                resp["last_seq"] = e.last_seq
            return resp
        except KeyError as e:
            return {"ok": False, "error": "unknown_tenant",
                    "transient": False, "detail": str(e)}
        except (ValueError, TypeError) as e:
            # e.g. attach naming an unregistered param set, an ingest
            # with a non-numeric/non-finite field — rejected before any
            # lane mutation, so compile counters and resident tenants
            # are untouched
            return {"ok": False, "error": "invalid_request",
                    "transient": False, "detail": str(e)}

    # ----------------------------------------------------- asyncio shell
    async def start(self) -> None:
        """Run the pump loop until ``stop()``."""
        self._wake = asyncio.Event()
        self._stopping = False
        self._task = asyncio.ensure_future(self._run())

    async def stop(self) -> None:
        self._stopping = True
        if self._wake is not None:
            self._wake.set()
        if self._task is not None:
            await self._task
            self._task = None
        self.pump(force=True)        # drain whatever is still queued

    async def _run(self) -> None:
        while not self._stopping:
            self.pump()
            deadline = self.batcher.next_deadline()
            wait = (self.cfg.max_wait_s if deadline is None
                    else max(0.0, deadline - self.clock()))
            try:
                await asyncio.wait_for(self._wake.wait(), timeout=wait)
            except asyncio.TimeoutError:
                pass
            self._wake.clear()


async def serve_jsonl(frontend: ServingFrontend, host: str = "127.0.0.1",
                      port: int = 0, max_line: int = 1 << 20):
    """Newline-delimited-JSON transport: one request dict per line, one
    response per line. Returns the listening ``asyncio.Server`` (query
    ``server.sockets[0].getsockname()`` for the bound port).

    Hardened against a hostile/buggy peer: reads are BOUNDED
    (``max_line`` bytes; an oversized line gets one ``invalid_request``
    response and the connection is dropped — there is no way to resync
    mid-line), malformed JSON and non-object payloads come back as
    structured errors, and any unexpected dispatcher failure answers
    ``internal_error`` on that one request. No input can kill the
    server task; other connections keep serving.
    """

    async def client(reader, writer):
        try:
            while True:
                try:
                    line = await reader.readline()
                except (asyncio.LimitOverrunError, ValueError):
                    # bounded read tripped: reject and drop the
                    # connection — the line has no parseable end
                    writer.write(json.dumps(
                        {"ok": False, "error": "invalid_request",
                         "transient": False,
                         "detail": f"line exceeds {max_line} bytes"}
                    ).encode() + b"\n")
                    await writer.drain()
                    break
                if not line:
                    break
                try:
                    req = json.loads(line)
                except json.JSONDecodeError as e:
                    resp = {"ok": False, "error": "bad_json",
                            "transient": False, "detail": str(e)}
                else:
                    try:
                        resp = frontend.handle(req)
                    except Exception as e:   # the transport never dies
                        resp = {"ok": False, "error": "internal_error",
                                "transient": False, "detail": str(e)}
                writer.write(json.dumps(resp).encode() + b"\n")
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass                             # peer vanished mid-exchange
        finally:
            writer.close()

    return await asyncio.start_server(client, host, port, limit=max_line)
