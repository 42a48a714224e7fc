"""Durable per-tenant event journal: the write-ahead log behind
lossless, exactly-once recovery.

Port of ``repro.serving.journal``, in its on-disk format: segments either
package writes are read by the other. ``append_batch`` journals the host
columns a batch already has; it refuses a batch on a device, whose read
would wait for the device every round.

Snapshots alone make the fleet crash-TOLERANT, not crash-LOSSLESS: a
restore rolls a tenant back to its newest snapshot and silently drops
every event ingested since, and the backpressure contract
(``RetryAfter`` -> client retries) invites at-least-once delivery with
nothing stopping a retried event from double-applying. This module
closes both holes (docs/ROBUSTNESS.md, "Recovery semantics"):

``EventJournal``
    an append-only, crc32-framed, segment-rotated write-ahead log, one
    directory per tenant. The frontend appends every accepted event
    BEFORE enqueueing it (write-ahead: an acked event is on disk) and a
    flush marker for every round the session actually applies, so the
    log records not just the events but the exact batch boundaries —
    which is what makes replay BITWISE, not merely value-preserving
    (batch boundaries change mailbox commit granularity). ``fsync`` is
    batched on a configurable interval (``fsync_s``; ``0`` = every
    append) measured on an injected clock.

exactly-once ingest
    each event may carry a client-supplied ``(client_id, seq)`` stamp.
    A sliding per-client dedup window (rebuilt from the journal on
    open, so it survives restarts) makes retried ingests idempotent:
    a duplicate is acknowledged (``{"ok": true, "dedup": true}``) and
    never re-journaled or re-enqueued.

recovery = snapshot + replay
    snapshot manifests record a journal ``cursor`` — ``(segment,
    offset, events, last_seq)`` — and ``replay`` drives the journal
    suffix after that cursor back through the normal ``DeadlineBatcher
    -> SessionManager.step`` pipeline, rebuilding each recorded flush
    with its original rows and padded width. Torn final records (a
    crash mid-append) are truncated on open, never fabricated; a
    crc-corrupt record stops replay with a warning (events past it are
    unrecoverable — the log is the source of truth, it never guesses).

truncation, coordinated with snapshot GC
    ``truncate_upto`` drops whole segments strictly below a retained
    snapshot's cursor, oldest first, so a crash mid-truncation leaves a
    contiguous (still replayable) suffix; ``cluster.truncate_journal``
    picks the OLDEST retained snapshot's cursor as the bound, so every
    snapshot ``checkpoint._gc`` keeps can still anchor a full replay
    (and ``checkpoint.save(floor=...)`` pins the anchor step outside
    the keep window as the belt-and-braces backstop).
"""
from __future__ import annotations

import json
import os
import struct
import time
import warnings
import zlib
from collections import deque
from dataclasses import dataclass, field

import numpy as np

_HEADER = struct.Struct("<II")          # (payload length, crc32(payload))
_SEG_FMT = "seg_{:08d}.wal"
#: sanity bound on one framed record — a length field past this is
#: corruption, not a huge event.
_MAX_RECORD = 1 << 20


def _host(col) -> np.ndarray:
    """A batch column as numpy, read from the host: a tensor on a device
    is refused, since reading it would wait for the device."""
    if hasattr(col, "device") and hasattr(col, "numpy"):     # a tensor
        if col.device.type != "cpu":
            raise TypeError(
                "journal append_batch takes the batch's host columns; got a "
                f"tensor on {col.device} (reading it back would wait for "
                "the device every round)")
        return col.numpy()
    return np.asarray(col)


def _seg_path(d: str, idx: int) -> str:
    return os.path.join(d, _SEG_FMT.format(idx))


def _seg_index(name: str) -> int:
    return int(name[4:-4])


@dataclass
class ReplayResult:
    """What one ``replay`` call did: ``rounds`` flushes re-applied,
    ``events`` rows inside them, ``pending`` journaled-but-never-flushed
    events (the caller re-enqueues them — they were accepted but no
    round consumed them before the crash), and ``corrupt`` when replay
    stopped early at a crc-corrupt record."""
    rounds: int = 0
    events: int = 0
    pending: list = field(default_factory=list)
    corrupt: bool = False


class _DedupWindow:
    """Per-client sliding seq window: ``seen(seq)`` is True for any seq
    already accepted within the last ``size`` sequence numbers — and,
    conservatively, for anything OLDER than the window (a retry that
    stale was almost certainly applied; re-applying would be the worse
    failure). Out-of-order first deliveries inside the window are
    accepted exactly once."""

    def __init__(self, size: int):
        self.size = int(size)
        self.max_seq: int | None = None
        self._in_window: set[int] = set()

    def seen(self, seq: int) -> bool:
        if self.max_seq is None or seq > self.max_seq:
            return False
        if seq <= self.max_seq - self.size:
            return True
        return seq in self._in_window

    def accept(self, seq: int) -> None:
        self._in_window.add(seq)
        if self.max_seq is None or seq > self.max_seq:
            self.max_seq = seq
            lo = self.max_seq - self.size
            self._in_window = {s for s in self._in_window if s > lo}


class _TenantLog:
    """One tenant's segment chain + counters + dedup state."""

    def __init__(self, d: str, *, segment_bytes: int, dedup_window: int):
        self.dir = d
        self.segment_bytes = int(segment_bytes)
        self.dedup_window = int(dedup_window)
        self.appended = 0        # next event index
        self.flushed = 0         # events covered by flush markers
        #: (event idx, segment, offset) of every journaled-not-flushed
        #: event — head is the replay cursor's low-water mark.
        self.unflushed: deque = deque()
        self.windows: dict[str, _DedupWindow] = {}
        self.seg = 0
        self.off = 0
        self._f = None
        self._dirty = False
        self._wedged = False     # a torn write happened: appends refuse
        os.makedirs(d, exist_ok=True)
        self._recover()

    # ----------------------------------------------------------- open
    def segments(self) -> list[int]:
        return sorted(_seg_index(f) for f in os.listdir(self.dir)
                      if f.startswith("seg_") and f.endswith(".wal"))

    def _recover(self) -> None:
        """Scan every retained segment: rebuild counters + dedup windows
        (replaying the log's own bookkeeping), truncate a torn tail in
        the final segment, and position the append head."""
        segs = self.segments()
        if not segs:
            self._open_segment(0, 0)
            return
        for si, seg in enumerate(segs):
            last = si == len(segs) - 1
            end, status = 0, "clean"
            for off, rec in _scan(_seg_path(self.dir, seg)):
                if rec is None:
                    status = off       # "torn" | "corrupt"
                    break
                end = off
                self._note_scanned(rec)
            if status == "torn" and last:
                # a crash mid-append: truncate the partial record —
                # it was never acked, so dropping it loses nothing
                warnings.warn(
                    f"journal {self.dir} segment {seg}: torn final "
                    f"record truncated at offset {end}")
                with open(_seg_path(self.dir, seg), "r+b") as f:
                    f.truncate(end)
            elif status != "clean":
                warnings.warn(
                    f"journal {self.dir} segment {seg}: {status} record; "
                    "records beyond it are unreachable")
        self._open_segment(segs[-1],
                           os.path.getsize(_seg_path(self.dir, segs[-1])))

    def _note_scanned(self, rec: dict) -> None:
        if rec["k"] == "ev":
            i = rec["i"]
            self.appended = max(self.appended, i + 1)
            if rec.get("c") is not None:
                self.window_for(rec["c"]).accept(rec["q"])
        elif rec["k"] == "fl":
            top = rec["a"] + rec["n"]
            self.flushed = max(self.flushed, top)
            self.appended = max(self.appended, top)
        while self.unflushed and self.unflushed[0][0] < self.flushed:
            self.unflushed.popleft()
        if rec["k"] == "ev" and rec["i"] >= self.flushed:
            self.unflushed.append((rec["i"], rec["_seg"], rec["_off"]))

    def _open_segment(self, idx: int, off: int) -> None:
        if self._f is not None:
            self._f.close()
        self.seg, self.off = idx, off
        self._f = open(_seg_path(self.dir, idx), "ab")

    # --------------------------------------------------------- append
    def write(self, rec: dict, torn: bool = False) -> tuple[int, int]:
        """Append one framed record; returns its ``(segment, offset)``
        position (rotation may move the append head first)."""
        if self._wedged:
            raise OSError(f"journal {self.dir} is wedged after a torn "
                          "write; reopen to recover")
        if self.off >= self.segment_bytes:
            self.fsync()
            self._open_segment(self.seg + 1, 0)
        pos = (self.seg, self.off)
        payload = json.dumps(rec, separators=(",", ":")).encode()
        frame = _HEADER.pack(len(payload), zlib.crc32(payload)) + payload
        if torn:
            # simulate a crash mid-write: half the frame reaches disk,
            # the process is as good as dead for this log
            self._f.write(frame[:max(_HEADER.size, len(frame) // 2)])
            self._f.flush()
            self._wedged = True
            raise OSError(f"torn journal write in {self.dir} (injected)")
        self._f.write(frame)
        # write-through to the OS now (a reopen sees it); durability is
        # the batched fsync's job
        self._f.flush()
        self.off += len(frame)
        self._dirty = True
        return pos

    def fsync(self) -> None:
        if self._f is not None and self._dirty:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._dirty = False

    def window_for(self, client_id: str) -> _DedupWindow:
        w = self.windows.get(client_id)
        if w is None:
            w = self.windows[client_id] = _DedupWindow(self.dedup_window)
        return w

    def close(self) -> None:
        if self._f is not None:
            if not self._wedged:
                self.fsync()
            self._f.close()
            self._f = None


def _scan(path: str):
    """Yield ``(end offset, record dict)`` per intact record; on a bad
    frame yield ``(status, None)`` — ``"torn"`` (incomplete bytes at the
    tail) or ``"corrupt"`` (full frame, crc/length mismatch) — and stop.
    Each record dict carries its own position as ``_seg``/``_off``."""
    seg = _seg_index(os.path.basename(path))
    with open(path, "rb") as f:
        off = 0
        while True:
            head = f.read(_HEADER.size)
            if not head:
                return
            if len(head) < _HEADER.size:
                yield "torn", None
                return
            length, crc = _HEADER.unpack(head)
            if length > _MAX_RECORD:
                yield "corrupt", None
                return
            payload = f.read(length)
            if len(payload) < length:
                yield "torn", None
                return
            if zlib.crc32(payload) != crc:
                yield "corrupt", None
                return
            try:
                rec = json.loads(payload)
            except json.JSONDecodeError:
                yield "corrupt", None
                return
            rec["_seg"], rec["_off"] = seg, off
            off += _HEADER.size + length
            yield off, rec


class EventJournal:
    """The fleet's write-ahead event log: one ``_TenantLog`` per tenant
    under ``root`` (see module docstring).

    ``fsync_s`` batches durability: an append fsyncs only when the
    injected ``clock`` says the last fsync is at least that old
    (``0.0`` = fsync every append). ``segment_bytes`` bounds segment
    files (rotation keeps truncation granular); ``dedup_window`` sizes
    the per-client sliding seq window — it must exceed a client's
    maximum in-flight retry depth (docs/ROBUSTNESS.md).
    """

    def __init__(self, root: str, *, fsync_s: float = 0.0,
                 segment_bytes: int = 1 << 20, dedup_window: int = 1024,
                 clock=time.monotonic):
        if dedup_window < 1:
            raise ValueError(f"dedup_window must be >= 1, got "
                             f"{dedup_window}")
        self.root = root
        self.fsync_s = float(fsync_s)
        self.segment_bytes = int(segment_bytes)
        self.dedup_window = int(dedup_window)
        self.clock = clock
        self._logs: dict[str, _TenantLog] = {}
        self._last_fsync = clock()
        self.appends = 0
        self.fsyncs = 0
        self.last_replay: ReplayResult | None = None
        os.makedirs(root, exist_ok=True)

    def log_for(self, tid: str) -> _TenantLog:
        log = self._logs.get(tid)
        if log is None:
            log = self._logs[tid] = _TenantLog(
                os.path.join(self.root, tid),
                segment_bytes=self.segment_bytes,
                dedup_window=self.dedup_window)
        return log

    # ------------------------------------------------------ hot path
    def is_duplicate(self, tid: str, client_id: str, seq: int) -> bool:
        """Query-only dedup check (the accept happens in
        ``append_event`` — a rejected/failed append never burns a seq)."""
        return self.log_for(tid).window_for(str(client_id)).seen(int(seq))

    def last_seq(self, tid: str, client_id) -> int | None:
        """Highest accepted seq for ``(tid, client_id)`` — what a
        reconnecting client resumes after (``RetryAfter.last_seq``)."""
        if client_id is None:
            return None
        w = self.log_for(tid).windows.get(str(client_id))
        return None if w is None else w.max_seq

    def append_event(self, tid: str, src: int, dst: int, eid: int,
                     ts: float, neg_dst: int = 0, *,
                     client_id=None, seq=None, torn: bool = False) -> None:
        """Journal one accepted event (call BEFORE enqueueing it).
        Raises ``OSError`` on write failure — the caller must then
        REJECT the ingest (transient), because an event that is not on
        disk is a durability promise the fleet cannot keep."""
        log = self.log_for(tid)
        rec = {"k": "ev", "i": log.appended,
               "e": [int(src), int(dst), int(eid), float(ts),
                     int(neg_dst)]}
        if client_id is not None and seq is not None:
            rec["c"] = str(client_id)
            rec["q"] = int(seq)
        pos = log.write(rec, torn=torn)
        log.unflushed.append((log.appended, *pos))
        log.appended += 1
        if client_id is not None and seq is not None:
            log.window_for(str(client_id)).accept(int(seq))
        self.appends += 1
        self._maybe_fsync()

    def note_flush(self, tid: str, n: int, width: int) -> None:
        """Journal one flush marker: the session is about to apply the
        tenant's oldest ``n`` pending events as a batch padded to
        ``width`` rows. Markers are what make replay rebuild the EXACT
        batch boundaries (and therefore the exact trajectory)."""
        log = self.log_for(tid)
        log.write({"k": "fl", "a": log.flushed, "n": int(n),
                   "w": int(width)})
        log.flushed += int(n)
        for _ in range(int(n)):
            if log.unflushed:
                log.unflushed.popleft()
        self._maybe_fsync()

    def append_batch(self, tid: str, batch) -> None:
        """Journal one offline ``EdgeBatch`` as its valid rows plus one
        flush marker — the offline serve path's WAL hook (the
        stream hands whole batches to the session, so the batch IS the
        flush boundary; ``w`` records the padded width replay rebuilds).
        The columns must be on the host (numpy, or CPU tensors)."""
        valid = _host(batch.valid)
        n = int(valid.sum())
        src, dst = _host(batch.src), _host(batch.dst)
        eid, ts = _host(batch.eid), _host(batch.ts)
        neg = _host(batch.neg_dst)
        for i in np.flatnonzero(valid):
            self.append_event(tid, src[i], dst[i], eid[i], ts[i], neg[i])
        if n:
            self.note_flush(tid, n, int(valid.shape[0]))

    def _maybe_fsync(self) -> None:
        now = self.clock()
        if self.fsync_s > 0 and (now - self._last_fsync) < self.fsync_s:
            return
        self.flush()

    def flush(self) -> None:
        """fsync every dirty tenant log now (also the close/exit path)."""
        for log in self._logs.values():
            if log._dirty:
                log.fsync()
                self.fsyncs += 1
        self._last_fsync = self.clock()

    # ------------------------------------------------------- cursors
    def cursor(self, tid: str) -> dict:
        """The tenant's replay cursor, recorded into snapshot manifests:
        ``segment``/``offset`` locate the oldest record a replay from
        this snapshot needs (the head of the unflushed queue, or the
        append tail when nothing is pending), ``events`` counts the
        flushes already inside the snapshotted state, and ``last_seq``
        is the per-client dedup high-water mark at capture time."""
        log = self.log_for(tid)
        if log.unflushed:
            _idx, seg, off = log.unflushed[0]
        else:
            seg, off = log.seg, log.off
        return {"segment": seg, "offset": off, "events": log.flushed,
                "last_seq": {c: w.max_seq
                             for c, w in sorted(log.windows.items())
                             if w.max_seq is not None}}

    # -------------------------------------------------------- replay
    def records(self, tid: str, segment: int = 0, offset: int = 0):
        """Iterate intact records from ``(segment, offset)`` to the end
        of the log, across segment boundaries. Ends with a warning at
        the first corrupt record (yields nothing past it)."""
        log = self.log_for(tid)
        for seg in log.segments():
            if seg < segment:
                continue
            path = _seg_path(log.dir, seg)
            start = offset if seg == segment else 0
            for end, rec in _scan(path):
                if rec is None:
                    warnings.warn(
                        f"journal {log.dir} segment {seg}: replay "
                        f"stopped at a {end} record")
                    yield None
                    return
                if rec["_off"] >= start:
                    yield rec

    def replay(self, tid: str, cursor: dict, step_fn, *,
               as_tid: str | None = None) -> ReplayResult:
        """Re-apply the journal suffix after ``cursor`` through the
        normal ``DeadlineBatcher -> step`` pipeline: each recorded flush
        marker rebuilds its batch from the journaled events — same rows,
        same order, same padded width — and hands it to ``step_fn`` as
        one round. ``as_tid`` renames the batches when the tenant was
        restored under a different id. Returns a ``ReplayResult`` (also
        stashed as ``self.last_replay``); ``pending`` holds journaled
        events no marker ever covered — accepted but never applied, the
        caller re-enqueues them into its live batcher."""
        from repro_torch.serving.frontend import (DeadlineBatcher,
                                                  FrontendConfig)

        out = as_tid or tid
        e0 = int(cursor.get("events", 0))
        res = ReplayResult()
        pending: list = []        # (idx, src, dst, eid, ts, neg, c, q)
        for rec in self.records(tid, int(cursor.get("segment", 0)),
                                int(cursor.get("offset", 0))):
            if rec is None:
                res.corrupt = True
                break
            if rec["k"] == "ev":
                if rec["i"] >= e0:
                    pending.append((rec["i"], *rec["e"], rec.get("c"),
                                    rec.get("q")))
            elif rec["k"] == "fl":
                a, n, w = rec["a"], rec["n"], rec["w"]
                if a + n <= e0:
                    continue              # flush already in the snapshot
                take = [p for p in pending[:n] if p[0] >= max(a, e0)]
                pending = pending[len(take):]
                if not take:
                    continue
                batcher = DeadlineBatcher(
                    FrontendConfig(max_rows=len(take), pad_quantum=w,
                                   queue_rows=max(len(take), 1)),
                    clock=lambda: 0.0)
                batcher.add_tenant(out)
                for _idx, src, dst, eid, ts, neg, _c, _q in take:
                    batcher.submit(out, src, dst, eid, ts, neg)
                batches, _arrivals = batcher.take()
                step_fn(batches)
                res.rounds += 1
                res.events += len(take)
        res.pending = [p[1:] for p in pending]
        self.last_replay = res
        return res

    # ---------------------------------------------------- truncation
    def truncate_upto(self, tid: str, cursor: dict) -> int:
        """Drop whole segments strictly below ``cursor["segment"]``,
        OLDEST FIRST — a crash mid-truncation leaves a contiguous
        suffix, so the journal stays replayable from every cursor at or
        above the bound and re-running the truncation completes it.
        Returns the number of segments removed. The caller owns the
        coordination contract: ``cursor`` must be the OLDEST retained
        snapshot's (``cluster.truncate_journal``)."""
        log = self.log_for(tid)
        bound = int(cursor.get("segment", 0))
        removed = 0
        for seg in log.segments():
            if seg >= bound or seg == log.seg:
                break
            os.remove(_seg_path(log.dir, seg))
            removed += 1
        return removed

    # ------------------------------------------------------- lifecycle
    def stats(self) -> dict:
        return {"appends": self.appends, "fsyncs": self.fsyncs,
                "tenants": {tid: {"appended": log.appended,
                                  "flushed": log.flushed,
                                  "segments": len(log.segments())}
                            for tid, log in sorted(self._logs.items())}}

    def close(self) -> None:
        for log in self._logs.values():
            log.close()
        self._logs.clear()
