"""Journal smoke: kill mid-stream, recover by snapshot and journal replay.

Port of the reference's ``tools/journal_smoke.py``. One tenant
(``sat+lut+np4``, fused tier) serves behind a journaled
``ServingFrontend`` on a ``FakeClock``; every event carries a
``(client_id, seq)`` stamp. Checked:

- kill and recover: the session is dropped after round 6 of 10 (no
  journal close, no last fsync) with a snapshot at round 4;
  ``cluster.restore_tenant(journal=...)`` in a fresh session reloads the
  snapshot and replays the journal's later flushes through the batcher
  into ``step``: the recovered state equals the state at the kill bit
  for bit, and the run continued to the end equals an uninterrupted twin
  bit for bit;
- after the restore round the layout is not rebuilt (``relayouts``
  frozen), and every round is one call;
- duplicate fuzz: every event is sent twice with the same stamp; every
  duplicate is acked ``dedup: true`` (never queued again) and the run
  lands on the send-once twin's state bit for bit;
- on the card, ``fused_step`` launched once a round.

Run on the card, or with ``--device cpu``::

    PYTHONPATH=src python -m repro_torch.launch.journal_smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.journal_smoke --paper
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

from repro_torch.launch.serve_smoke import (TICK_S, add_args, bitwise,
                                            events, frontend_config,
                                            model_from_args)

ROUNDS, KILL_AT, SNAP_AT = 10, 6, 4


def run(g, cfg, params, device, rows: int, *, log=print) -> dict:
    """The journal leg. Returns ``{"ok", "checks", "launches",
    "want_launches", "replayed"}``; ``launches`` are the kernel launches
    of the served rounds, replayed ones included (0 on the CPU)."""
    from repro_torch.kernels import ops
    from repro_torch.serving import cluster
    from repro_torch.serving.faults import FakeClock
    from repro_torch.serving.frontend import ServingFrontend
    from repro_torch.serving.journal import EventJournal
    from repro_torch.serving.session import SessionManager

    def fleet():
        return SessionManager(params, g.edge_feats, g.node_feats, model=cfg,
                              use_kernels="fused", device=device)

    def frontend(mgr, journal, clock):
        return ServingFrontend(mgr, frontend_config(rows), clock=clock,
                               journal=journal)

    ev = events(g, 0, rows * ROUNDS)
    root = tempfile.mkdtemp(prefix="journal-smoke-")
    jroot, sroot = os.path.join(root, "wal"), os.path.join(root, "snaps")
    launches = dict.fromkeys(ops.LAUNCHES, 0)

    def counted(fn):
        ops.reset_launch_counts()
        out = fn()
        for n, k in ops.launch_counts().items():
            launches[n] += k
        return out

    # ingest, snapshot at SNAP_AT, killed after KILL_AT rounds
    clock = FakeClock()
    journal = EventJournal(jroot, fsync_s=0.05, clock=clock)
    mgr = fleet()
    t0 = mgr.add_tenant(name="t0")
    fe = frontend(mgr, journal, clock)

    def serve_until_kill():
        for r in range(KILL_AT):
            for i in range(r * rows, (r + 1) * rows):
                fe.submit(t0, *ev[i], client_id="c0", seq=i)
            clock.advance(TICK_S)
            assert fe.pump(), "deadline flush did not fire"
            if r + 1 == SNAP_AT:
                cluster.snapshot_tenant(
                    mgr, t0, sroot, step=SNAP_AT,
                    extra_meta={"journal": journal.cursor(t0)})
        mgr.sync()

    counted(serve_until_kill)
    at_kill = mgr.state_of(t0)
    del fe, mgr, journal       # killed: no close, no final fsync

    # recover = snapshot + replay, then run to the end
    j2 = EventJournal(jroot, fsync_s=0.05, clock=clock)
    mgr2 = fleet()
    new = counted(lambda: cluster.restore_tenant(mgr2, sroot, "t0",
                                                 journal=j2))
    res = j2.last_replay
    mgr2.sync()
    ok = {"recovered state equals the state at the kill": (
        res is not None and not res.corrupt
        and res.rounds == KILL_AT - SNAP_AT
        and bitwise(mgr2.state_of(new), at_kill))}
    fe2 = frontend(mgr2, j2, clock)
    c0 = mgr2.compile_counters()

    def serve_rest():
        for r in range(KILL_AT, ROUNDS):
            for i in range(r * rows, (r + 1) * rows):
                fe2.submit(new, *ev[i], client_id="c0", seq=i)
            clock.advance(TICK_S)
            assert fe2.pump(), "deadline flush did not fire"
        mgr2.sync()

    counted(serve_rest)
    j2.close()
    c = mgr2.compile_counters()
    ok["relayouts frozen after the restore round, one call a round"] = (
        c["relayouts"] == c0["relayouts"]
        and {m["launches"] for m in mgr2.metrics} == {1})

    # the uninterrupted twin, no journal
    twin_clock = FakeClock()
    twin = fleet()
    tw = twin.add_tenant(name="tw")
    few = frontend(twin, None, twin_clock)
    for r in range(ROUNDS):
        for i in range(r * rows, (r + 1) * rows):
            few.submit(tw, *ev[i])
        twin_clock.advance(TICK_S)
        few.pump()
    twin.sync()
    ok["recovered run equals the uninterrupted twin"] = bitwise(
        mgr2.state_of(new), twin.state_of(tw))

    # duplicate fuzz: every event twice, through the wire protocol
    fuzz_clock = FakeClock()
    jf = EventJournal(os.path.join(root, "wal-fuzz"), clock=fuzz_clock)
    fz = fleet()
    tf = fz.add_tenant(name="t0")
    fef = frontend(fz, jf, fuzz_clock)
    acks = []

    def fuzz():
        for r in range(ROUNDS):
            for i in range(r * rows, (r + 1) * rows):
                src, dst, eid, ts, neg = ev[i]
                req = {"op": "ingest", "tid": tf, "src": src, "dst": dst,
                       "eid": eid, "ts": ts, "neg_dst": neg,
                       "client_id": "c0", "seq": i}
                acks.append((fef.handle(req), fef.handle(req)))
            fuzz_clock.advance(TICK_S)
            fef.pump()
        fz.sync()

    counted(fuzz)
    jf.close()
    ok["duplicates acked as dedup, send-once trajectory"] = (
        all(a["ok"] and "dedup" not in a and b == {
            "ok": True, "dedup": True, "tid": tf, "client_id": "c0",
            "seq": i} for i, (a, b) in enumerate(acks))
        and fef.dedups == len(acks) == rows * ROUNDS
        and bitwise(fz.state_of(tf), twin.state_of(tw)))
    shutil.rmtree(root, ignore_errors=True)

    steps = KILL_AT + res.rounds + (ROUNDS - KILL_AT) + ROUNDS
    want = dict.fromkeys(launches, 0)
    if device.type == "cuda":
        want["fused_step"] = steps
    ok["kernel launches"] = launches == want
    log(f"journal leg: killed after round {KILL_AT}/{ROUNDS} ({rows} rows a "
        f"round), snapshot at {SNAP_AT}, replayed {res.rounds} round(s) "
        f"({res.events} events); {fef.dedups} duplicates acked; kernel "
        f"launches {launches} (want {want})", flush=True)
    for what, good in ok.items():
        log(f"journal leg: {what}: {'OK' if good else 'FAIL'}", flush=True)
    return {"ok": all(ok.values()), "checks": ok, "launches": launches,
            "want_launches": want, "replayed": res.rounds}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_args(ap)
    args = ap.parse_args(argv)
    res = run(*model_from_args(args))
    print(f"journal-smoke: {'OK' if res['ok'] else 'FAIL'}")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
