"""Serving smoke: the online front end over a reserve-enabled session.

Port of the reference's ``tools/serve_smoke.py``. A reserve-enabled
``SessionManager`` behind ``ServingFrontend`` serves 3 tenants on 2
cohorts (the student ``sat+lut+np4`` on the fused tier, two tenants, and
on the staged tier, one); every edge goes in as an NDJSON request through
``handle``. A 4th tenant is attached into the staged cohort's spare slot
mid-stream and detached again. Checked:

- the round layout is built during the warm-up and never again
  (``relayouts`` frozen: the live attach and detach landed in a spare
  slot), and every round is one call (``launches_per_round == {1}``);
- no event was rejected or dropped;
- a 1-in-8 sampled ``RoundTracer`` on the same fake clock records the
  ingest, flush, stage, launch, h2d and drain spans on sampled rounds
  only (one drain span a sampled round), and the Chrome export has them;
- ``summary()["per_tenant"]`` has SLO burn for every tenant;
- on the card, each kernel launched once a round (both cohorts run every
  round).

``guard_cost`` times the same fleet's rounds bare (``SessionManager.step``)
against the rounds through a ``FleetGuard`` that checks every round (the
sentinel's one host read a round) and against the whole stack (the
server's half of the NDJSON work, journal, guard), in interleaved blocks,
and gives each against bare as the median of its paired differences with
a 95% interval.

Run on the card, or with ``--device cpu``::

    PYTHONPATH=src python -m repro_torch.launch.serve_smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_smoke --paper

The default is a small graph at f = 16 and 8 rows a flush; ``--paper`` is
the Wikipedia path at paper width with B = 200 rows a flush
(``launch/main_path.py``). ``launch/chaos_smoke.py`` and
``launch/journal_smoke.py`` reuse this module's helpers.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch.core import mailbox

#: the fake clock's step a round: past the front end's 5 ms deadline
TICK_S = 0.006


#: the small graph of a smoke without ``--paper``: edges, width, rows a flush
SMALL_EDGES, SMALL_F, SMALL_ROWS = 500, 16, 8


def add_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--paper", action="store_true",
                    help="the Wikipedia path at paper width, B = 200 rows a "
                         "flush (launch/main_path.py)")


def model_from_args(args) -> tuple:
    """``(graph, cfg, params, device, rows)`` for a smoke's CLI: the small
    graph, or with ``--paper`` the Wikipedia path."""
    from repro_torch.core import pipeline as pl, tgn
    from repro_torch.data import temporal_graph as tgd
    from repro_torch.launch import main_path as mp
    from repro_torch.utils import resolve_device
    device = resolve_device(args.device)
    if args.paper:
        g, cfg, params = mp.build(device)
        return g, cfg, params, device, mp.B
    g = tgd.wikipedia_like(n_edges=SMALL_EDGES)
    f = SMALL_F
    cfg = pl.variant_config("sat+lut+np4", n_nodes=g.cfg.n_nodes,
                            n_edges=g.n_edges, f_edge=g.cfg.f_edge,
                            f_mem=f, f_time=f, f_emb=f, m_r=10)
    params = tgn.init_params(torch.Generator().manual_seed(0), cfg, device)
    return g, cfg, params, device, SMALL_ROWS


def frontend_config(rows: int):
    """Flush at ``rows`` rows or 5 ms, widths padded to ``rows``."""
    from repro_torch.serving.frontend import FrontendConfig
    return FrontendConfig(max_wait_s=0.005, max_rows=rows,
                          queue_rows=4 * rows, pad_quantum=rows)


def events(g, lo: int, n: int) -> list:
    """Edges ``lo .. lo + n`` of ``g`` as ``(src, dst, eid, ts, neg_dst)``
    events, chronological."""
    E = g.n_edges
    return [(int(g.src[i]), int(g.dst[i]), i, float(g.ts[i]),
             int(g.dst[(i + 3) % E])) for i in range(lo, lo + n)]


def bitwise(a: mailbox.VertexState, b: mailbox.VertexState) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def round_kernels(mgr) -> dict:
    """Kernel launches a coalesced round of ``mgr`` issues on the card:
    every cohort steps every round, idle ones on a masked row."""
    from repro_torch.kernels import ops
    from repro_torch.launch.main_path import lane_kernels
    want = dict.fromkeys(ops.LAUNCHES, 0)
    for c in mgr._cohorts.values():
        for name in lane_kernels(c.pipeline.describe()):
            want[name] += 1
    return want


def _request(fe, req: dict) -> dict:
    """One request through the NDJSON protocol: encoded, decoded, handled,
    and the reply encoded and decoded."""
    return json.loads(json.dumps(fe.handle(json.loads(json.dumps(req)))))


def run(g, cfg, params, device, rows: int, *, log=print) -> dict:
    """The serve leg. Returns ``{"ok", "rounds", "edges", "launches",
    "want_launches", "mean_round_ms", "p99_round_ms", "throughput_eps",
    "pump_ms"}``; ``launches`` are the kernel launches of the served
    rounds (0 on the CPU)."""
    from repro_torch.obs import RoundTracer
    from repro_torch.serving.faults import FakeClock
    from repro_torch.serving.frontend import ServingFrontend
    from repro_torch.serving.session import SessionManager

    from repro_torch.kernels import ops

    mgr = SessionManager(params, g.edge_feats, g.node_feats, model=cfg,
                         reserve=True, device=device)
    # 3 tenants on 2 cohorts; each cohort's capacity class is 2, so the
    # fused one is full and the staged one has a spare slot
    tids = [mgr.add_tenant(use_kernels="fused", name="t0"),
            mgr.add_tenant(use_kernels="fused", name="t1"),
            mgr.add_tenant(use_kernels="staged", name="t2")]
    clock = FakeClock()
    tracer = RoundTracer(clock=clock, sample_every=8)
    fe = ServingFrontend(mgr, frontend_config(rows), clock=clock,
                         tracer=tracer, slo_ms=25.0)
    span = (g.n_edges - rows) // 4
    window = {t: i * span for i, t in enumerate(tids + ["live"])}
    sent = dict.fromkeys(window, 0)
    acks, pump_s = [], []

    def feed(active, rounds):
        for _ in range(rounds):
            for tid in active:
                lo = window[tid] + sent[tid]
                for src, dst, eid, ts, neg in events(g, lo, rows):
                    acks.append(_request(fe, {
                        "op": "ingest", "tid": tid, "src": src, "dst": dst,
                        "eid": eid, "ts": ts, "neg_dst": neg}))
                sent[tid] += rows
            clock.advance(TICK_S)
            t = time.perf_counter()
            assert fe.pump(), "deadline flush did not fire"
            pump_s.append(time.perf_counter() - t)

    ops.reset_launch_counts()    # no kernel launches on the CPU
    feed(tids, 2)                         # warm-up: the layout is built
    mgr.sync()
    c0 = mgr.compile_counters()
    resp = _request(fe, {"op": "attach", "use_kernels": "staged",
                         "name": "live"})
    attach_fast = (resp["ok"] and not resp["admission"]["relayout"]
                   and mgr.cohort_of("live") is mgr.cohort_of("t2"))
    feed(tids + ["live"], 5)
    resp = _request(fe, {"op": "detach", "tid": "live"})
    detach_fast = resp["ok"] and not resp["admission"]["relayout"]
    feed(tids, 5)
    mgr.sync()
    launches = ops.launch_counts()
    c1 = mgr.compile_counters()
    stats = _request(fe, {"op": "stats"})["stats"]
    rounds = stats["rounds"]
    per_round = round_kernels(mgr)
    want = {n: (rounds * k if device.type == "cuda" else 0)
            for n, k in per_round.items()}
    edges = sum(sent.values())
    round_calls = {m["launches"] for m in mgr.metrics}
    ok = {
        "layout frozen after the warm-up": (
            c1["relayouts"] == c0["relayouts"] == 1
            and c1["round_calls"] == rounds),
        "live attach and detach in a spare slot": attach_fast
        and detach_fast,
        "one call a round": round_calls == {1},
        "every event acked, none rejected or dropped": (
            all(a["ok"] for a in acks) and stats["rejected"] == 0
            and fe.orphaned == 0 and stats["accepted"] == edges),
        "kernel launches": launches == want,
    }

    # sampled spans, their export, SLO burn
    names = {s.name for s in tracer.spans}
    drains = sum(s.name == "drain" for s in tracer.spans)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="serve-smoke-")
    os.close(fd)
    try:
        tracer.write_chrome(path)
        with open(path) as f:
            exported = {e["name"] for e in json.load(f)["traceEvents"]
                        if e.get("ph") == "X"}
    finally:
        os.unlink(path)
    want_spans = {"ingest", "flush", "stage", "launch", "h2d", "drain"}
    summary = mgr.summary()
    per_tenant = summary["per_tenant"]
    ok["spans on 1-in-8 sampled rounds only"] = (
        tracer.rounds_seen == rounds
        and tracer.rounds_sampled == (rounds + 7) // 8
        and drains == tracer.rounds_sampled
        and want_spans <= names and want_spans <= exported
        and tracer.dropped == 0)
    ok["SLO burn for every tenant"] = (
        set(per_tenant) == set(mgr.tenants)
        and all(st["slo"]["events"] > 0
                and 0.0 <= st["slo"]["budget_remaining"] <= 1.0
                for st in per_tenant.values()))
    pump_ms = np.array(pump_s) * 1e3
    log(f"serve leg: {edges} edges in {rounds} rounds of {rows} rows a "
        f"tenant, {len(mgr.tenants)} tenants / {len(mgr._cohorts)} cohorts "
        f"(live attach + detach), compile {c1}; {tracer.rounds_sampled}/"
        f"{tracer.rounds_seen} rounds traced, spans {sorted(names)}; "
        f"kernel launches {launches} (want {want})", flush=True)
    log(f"serve leg: round period (session summary; ingest, the client's "
        f"and the server's JSON included) mean {summary['mean_round_ms']:.3f}"
        f" ms, p99 bucket {summary['p99_round_ms']:.3f} ms (of "
        f"{summary['rounds']} rounds: the slowest one's), "
        f"{summary['throughput_eps']:.0f} edges/s; pump (host, no wait) mean "
        f"{pump_ms.mean():.3f} ms, max {pump_ms.max():.3f} ms of "
        f"{len(pump_ms)}", flush=True)
    for what, good in ok.items():
        log(f"serve leg: {what}: {'OK' if good else 'FAIL'}", flush=True)
    return {"ok": all(ok.values()), "checks": ok, "rounds": rounds,
            "edges": edges, "launches": launches, "want_launches": want,
            "mean_round_ms": summary["mean_round_ms"],
            "p99_round_ms": summary["p99_round_ms"],
            "throughput_eps": summary["throughput_eps"],
            "pump_ms": float(pump_ms.mean())}


def median_ci(d) -> tuple:
    """``(median, lo, hi)`` of the paired differences ``d``, with the
    distribution-free 95% interval of the median (order statistics k and
    n + 1 - k, k the largest with P(Binomial(n, 1/2) < k) <= 0.025).
    Fewer than 6 pairs give no interval: ``lo, hi = -inf, inf``."""
    d = np.sort(np.asarray(d, dtype=float))
    n = len(d)
    k, tail = 0, 0.0
    while tail + math.comb(n, k) / 2 ** n <= 0.025:
        tail += math.comb(n, k) / 2 ** n
        k += 1
    if k == 0:
        return float(np.median(d)), -math.inf, math.inf
    return float(np.median(d)), float(d[k - 1]), float(d[n - k])


def guard_cost(g, cfg, params, device, rows: int, *, blocks: int = 24,
               rounds: int = 3, log=print) -> dict:
    """Ms a round of one fleet (3 tenants, np4 fused x2 and staged x1)
    three ways: bare ``SessionManager.step``, ``FleetGuard.step`` checking
    every round, and the whole stack (the server's half of the NDJSON
    work, ``handle``, the journal, the guard, ``pump``). Each block times
    ``rounds`` rounds of each way, synchronized at their ends, the ways'
    order rotated block by block; inputs (batches, encoded request lines)
    are built before the timer. Returns each way's median, the paired
    differences' median and 95% interval against bare (``median_ci``),
    and the journal's ms a round inside the stack."""
    from repro_torch.serving.faults import FakeClock
    from repro_torch.serving.frontend import ServingFrontend
    from repro_torch.serving.guard import FleetGuard
    from repro_torch.serving.journal import EventJournal
    from repro_torch.serving.session import SessionManager
    from repro_torch.data.stream import EdgeBatch

    mgr = SessionManager(params, g.edge_feats, g.node_feats, model=cfg,
                         reserve=True, device=device)
    tids = [mgr.add_tenant(use_kernels=t, name=f"t{i}")
            for i, t in enumerate(("fused", "fused", "staged"))]
    clock = FakeClock()
    guard = FleetGuard(mgr, clock=clock, check_every=1)
    jdir = tempfile.mkdtemp(prefix="guard-cost-wal-")
    journal = EventJournal(jdir, fsync_s=0.005, clock=clock)
    journal_s = [0.0]

    def timed(fn):
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                journal_s[0] += time.perf_counter() - t
        return call

    # the journal's whole share of the stack: its two calls from the front
    # end, fsyncs included
    journal.append_event = timed(journal.append_event)
    journal.note_flush = timed(journal.note_flush)
    fe = ServingFrontend(mgr, frontend_config(rows), clock=clock,
                         journal=journal)
    span = (g.n_edges - rows) // len(tids)
    # each tenant's window holds the warm-up and every block of every way
    avail = span // rows - 3
    rounds = max(1, min(rounds, avail // (3 * blocks)))
    blocks = min(blocks, avail // (3 * rounds))
    sent = [0] * len(tids)

    def next_events(i):
        ev = events(g, i * span + sent[i], rows)
        sent[i] += rows
        return ev

    def batches():
        out = {}
        for i, t in enumerate(tids):
            cols = list(zip(*next_events(i)))
            out[t] = EdgeBatch(np.array(cols[0], np.int32),
                               np.array(cols[1], np.int32),
                               np.array(cols[2], np.int32),
                               np.array(cols[3], np.float32),
                               np.ones(rows, bool),
                               np.array(cols[4], np.int32))
        return out

    def lines():
        return [json.dumps({"op": "ingest", "tid": t, "src": src, "dst": dst,
                            "eid": eid, "ts": ts,
                            "neg_dst": neg}).encode() + b"\n"
                for i, t in enumerate(tids)
                for src, dst, eid, ts, neg in next_events(i)]

    def serve(reqs):
        # the server's half of the protocol (frontend.serve_jsonl's loop)
        for line in reqs:
            json.dumps(fe.handle(json.loads(line))).encode()
        clock.advance(TICK_S)
        fe.pump()

    ways = {"bare": (batches, mgr.step), "guard": (batches, guard.step),
            "stack": (lines, serve)}
    for prep, fn in ways.values():        # warm-up
        fn(prep())
    journal_s[0] = 0.0
    times = {k: [] for k in ways}
    order = list(ways)
    for b in range(blocks):
        for k in order[b % 3:] + order[:b % 3]:
            prep, fn = ways[k]
            inputs = [prep() for _ in range(rounds)]
            mgr.sync()
            t = time.perf_counter()
            for x in inputs:
                fn(x)
            mgr.sync()
            times[k].append((time.perf_counter() - t) * 1e3 / rounds)
    journal.close()
    med = {k: float(np.median(v)) for k, v in times.items()}
    diff = {k: median_ci(np.array(times[k]) - np.array(times["bare"]))
            for k in ("guard", "stack")}
    jms = journal_s[0] * 1e3 / (blocks * rounds)
    n_ev = rows * len(tids)

    def said(k):
        m, lo, hi = diff[k]
        verdict = ("too few pairs for an interval" if math.isinf(lo)
                   else "resolved" if lo > 0 or hi < 0
                   else "unresolved: the interval holds 0")
        return (f"{m:+.3f} ms [{lo:+.3f}, {hi:+.3f}] ({verdict}; "
                f"{med[k] / med['bare']:.2f}x the bare median)")

    log(f"guard cost: {blocks} blocks of {rounds} rounds a way, order "
        f"rotated; medians bare {med['bare']:.3f}, guard (check_every = 1) "
        f"{med['guard']:.3f}, whole stack {med['stack']:.3f} ms a round",
        flush=True)
    log(f"guard cost: paired difference to bare, median [95% interval]: "
        f"guard {said('guard')}; whole stack {said('stack')}, "
        f"{diff['stack'][0] * 1e3 / n_ev:.1f} us an event over {n_ev} "
        f"events a round, of which the journal {jms:.3f} ms a round "
        f"({jms * 1e3 / n_ev:.1f} us an event)", flush=True)
    log(f"guard cost: blocks {times}", flush=True)
    return {**med, "guard_diff": diff["guard"], "stack_diff": diff["stack"],
            "journal_ms": jms, "blocks": blocks, "rounds": rounds,
            "events": n_ev}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_args(ap)
    args = ap.parse_args(argv)
    g, cfg, params, device, rows = model_from_args(args)
    res = run(g, cfg, params, device, rows)
    guard_cost(g, cfg, params, device, rows)
    print(f"serve-smoke: {'OK' if res['ok'] else 'FAIL'}")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
