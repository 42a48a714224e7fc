"""Chaos smoke: a deterministic fault plan against a guarded fleet.

Port of the reference's ``tools/chaos_smoke.py`` (its fault-plan leg;
``launch/journal_smoke.py`` is the kill-and-recover leg). A fleet of 3
tenants on 2 cohorts serves behind ``ServingFrontend`` with a
``FleetGuard``, a background ``TenantSnapshotWriter`` and a 1-in-4
``RoundTracer``, all on one ``FakeClock``:

- ``t0`` and ``t1``: ``sat+lut+np4+reservoir`` on the staged tier (one
  cohort); ``t0`` is the survivor, ``t1`` the sick tenant;
- ``t2``: ``sat+lut+np4`` on the fused tier, whose launch fails.

The plan fires one fault of each kind: ``t1``'s first snapshot write
fails (the writer retries it), ``t1``'s memory turns NaN at round 3
(``nan_state``), ``t2``'s launch fails at round 5 (``kernel_fail``) and
round 7 stalls for 1 s (``stall``). Checked:

- every fault fires and is detected once: one quarantine, one restore,
  one watchdog trip, one snapshot retry, and exactly as many
  degradations as injected kernel faults;
- ``t1`` is quarantined (its ingest refused with a ``quarantined``
  RetryAfter), restored from its newest valid snapshot, and continues:
  its final state equals a solo fleet stepped from that snapshot through
  its later batches;
- ``t2``'s cohort moves fused -> staged (one extra relayout): before the
  fault a round launches ``fused_step`` once and the staged kernels once
  (``t0``'s cohort), after it the staged kernels twice and ``fused_step``
  never; ``t2``'s final state equals a solo fleet that served its
  batches fused up to the fault and staged from it, its state carried
  across;
- the survivor ``t0`` equals a solo fleet fed its batches, bit for bit
  (a kernel tier's rows do not depend on the rows beside them);
- every round is one call, and the guard's spans and counters show in
  ``metrics_snapshot()``.

Run on the card, or with ``--device cpu``::

    PYTHONPATH=src python -m repro_torch.launch.chaos_smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.chaos_smoke --paper
"""
from __future__ import annotations

import argparse
import shutil
import sys
import tempfile

from repro_torch.launch.serve_smoke import (TICK_S, add_args, bitwise,
                                            events, frontend_config,
                                            model_from_args, round_kernels)

ROUNDS = 12
NAN_AT, FAIL_AT, STALL_AT = 3, 5, 7


def _solo(g, cfg, params, device, variant, tier, state, batches):
    """A one-tenant fleet on ``variant`` at ``tier``, from ``state`` (None:
    the initial state), stepped through ``batches``; its final state."""
    from repro_torch.serving.session import SessionManager
    solo = SessionManager(params, g.edge_feats, g.node_feats, model=cfg,
                          device=device)
    t = solo.add_tenant(variant, use_kernels=tier)
    if state is not None:
        solo.set_state(t, state)
    for b in batches:
        solo.step({t: b})
    solo.sync()
    return solo.state_of(t)


def run(g, cfg, params, device, rows: int, *, log=print) -> dict:
    """The chaos leg. Returns ``{"ok", "checks", "launches",
    "want_launches", "guard"}``; ``launches`` are the kernel launches of
    the served rounds (0 on the CPU)."""
    from repro_torch.kernels import ops
    from repro_torch.obs import RoundTracer
    from repro_torch.serving.cluster import TenantSnapshotWriter
    from repro_torch.serving.faults import FakeClock, Fault, FaultInjector
    from repro_torch.serving.frontend import RetryAfter, ServingFrontend
    from repro_torch.serving.guard import FleetGuard
    from repro_torch.serving.session import SessionManager

    res_v = "sat+lut+np4+reservoir"
    mgr = SessionManager(params, g.edge_feats, g.node_feats, model=cfg,
                         device=device)
    t0 = mgr.add_tenant(res_v, use_kernels="staged", name="t0")
    t1 = mgr.add_tenant(res_v, use_kernels="staged", name="t1")
    t2 = mgr.add_tenant(use_kernels="fused", name="t2")
    clock = FakeClock()
    tracer = RoundTracer(clock=clock, sample_every=4)
    fe = ServingFrontend(mgr, frontend_config(rows), clock=clock,
                         tracer=tracer, slo_ms=25.0, record_rounds=True)
    snap_dir = tempfile.mkdtemp(prefix="chaos-snap-")
    writer = TenantSnapshotWriter(snap_dir, keep=3, retries=2, obs=mgr.obs,
                                  sleep=lambda s: None)
    guard = FleetGuard(mgr, snapshot_root=snap_dir, writer=writer,
                       clock=clock, max_restores=3, backoff_s=0.02,
                       watchdog_s=0.5)
    plan = [Fault(kind="snapshot_io", tenant=t1, at=0),
            Fault(kind="nan_state", tenant=t1, at=NAN_AT),
            Fault(kind="kernel_fail", tenant=t2, at=FAIL_AT),
            Fault(kind="stall", at=STALL_AT, delay_s=1.0)]
    injector = FaultInjector(plan, clock=clock)
    mgr.set_faults(injector)

    span = (g.n_edges - rows) // 3
    rejects, per_round, snaps = [], [], {}
    c0 = None
    for r in range(ROUNDS):
        for i, tid in enumerate((t0, t1, t2)):
            for ev in events(g, i * span + r * rows, rows):
                try:
                    fe.submit(tid, *ev)
                except RetryAfter as e:          # quarantined ingest
                    rejects.append((r, e.tid, e.reason))
        clock.advance(TICK_S)
        ops.reset_launch_counts()
        assert fe.pump(), "deadline flush did not fire"
        per_round.append(ops.launch_counts())
        if c0 is None:                           # the layout is built
            c0 = mgr.compile_counters()
        if r % 2 == 0:                           # snapshot cadence; never
            for tid in mgr.tenants:              # a quarantined tenant;
                # a submission the writer skips (the tenant's previous
                # write still in flight) is no snapshot to restore from
                if (not mgr.is_quarantined(tid)
                        and writer.submit(mgr, tid, step=r)):
                    snaps.setdefault(tid, {})[r] = mgr.state_of(tid)
    mgr.sync()
    writer.close()

    gs = guard.snapshot()
    fired = sorted(f["kind"] for f in injector.fired)
    n_kernel = sum(f.kind == "kernel_fail" for f in plan)
    ok = {
        "every fault fired and was detected once": (
            injector.pending() == []
            and fired == ["kernel_fail", "nan_state", "snapshot_io",
                          "stall"]
            and gs["quarantines"] == 1 and gs["restores"] == 1
            and gs["watchdog_trips"] == 1 and gs["evictions"] == 0
            and gs["quarantined_now"] == []
            and mgr.obs.counter("snapshot.retries").value == 1
            and mgr.obs.counter("snapshot.failures").value == 0),
        "degradations equal the injected kernel faults": (
            gs["degradations"] == n_kernel),
    }

    # the sick tenant: quarantined, restored from its round-2 snapshot,
    # then served again
    view = guard.tenant_view(t1)
    restored_from = max(s for s in snaps[t1] if s < NAN_AT)
    log_t1 = [b[t1] for b in fe.round_log if t1 in b]
    served_after = [b[t1] for k, b in enumerate(fe.round_log)
                    if t1 in b and k > STALL_AT]
    want_t1 = _solo(g, cfg, params, device, res_v, "staged",
                    snaps[t1][restored_from], served_after)
    sick = {
        "restored": (not view["quarantined"] and view["restores"] == 1
                     and view["last_reason"] == "nonfinite_state"),
        "only its ingest rejected": bool(rejects) and {
            x[1:] for x in rejects} == {(t1, "quarantined")},
        "rounds served": len(log_t1) == ROUNDS - len(rejects) // rows,
        "state bitwise its solo replay": bitwise(mgr.state_of(t1), want_t1)}
    ok["sick tenant quarantined, restored, continued"] = all(sick.values())
    if not all(sick.values()):
        log(f"chaos leg: the sick tenant's checks {sick}; view {view}; "
            f"{len(log_t1)} rounds logged, {len(rejects)} rejects, restored "
            f"from round {restored_from}", flush=True)

    # the degraded cohort: a lane move fused -> staged, states carried
    c = mgr.compile_counters()
    before = [b[t2] for b in fe.round_log[:FAIL_AT]]
    after = [b[t2] for b in fe.round_log[FAIL_AT:]]
    mid = _solo(g, cfg, params, device, None, "fused", None, before)
    want_t2 = _solo(g, cfg, params, device, None, "staged", mid, after)
    cuda = device.type == "cuda"
    pre = {"lut_encode": 1, "gru_cell": 1, "sat_aggregate": 1,
           "fused_step": 1}
    post = round_kernels(mgr)
    want_launches = [dict(pre if r < FAIL_AT else post) for r in
                     range(ROUNDS)]
    if not cuda:
        want_launches = [dict.fromkeys(pre, 0)] * ROUNDS
    ok["fused cohort moved to staged in one relayout, state carried"] = (
        mgr.cohort_of(t2).tier == "staged"
        and c["relayouts"] == c0["relayouts"] + 1
        and post == {"lut_encode": 2, "gru_cell": 2, "sat_aggregate": 2,
                     "fused_step": 0}
        and per_round == want_launches
        and bitwise(mgr.state_of(t2), want_t2))

    # the survivor equals a fleet that never had the others
    want_t0 = _solo(g, cfg, params, device, res_v, "staged", None,
                    [b[t0] for b in fe.round_log])
    ok["survivor equals its solo replay"] = bitwise(mgr.state_of(t0),
                                                    want_t0)

    ms = fe.metrics_snapshot()
    guard_spans = {s.name for s in tracer.spans if s.cat == "guard"}
    ok["one call a round; guard counters and spans visible"] = (
        {m["launches"] for m in mgr.metrics} == {1}
        and fe.stats()["rounds"] == ROUNDS
        and ms.get("guard") == gs and fe.stats()["guard"] == gs
        and {"quarantine", "restore", "degrade", "watchdog"} <= guard_spans)
    shutil.rmtree(snap_dir, ignore_errors=True)

    launches = {n: sum(p[n] for p in per_round) for n in pre}
    want = {n: sum(p[n] for p in want_launches) for n in pre}
    log(f"chaos leg: {ROUNDS} rounds of {rows} rows a tenant, faults fired "
        f"{fired}, guard {gs}; {len(rejects)} quarantined-ingest rejects; "
        f"relayouts +{c['relayouts'] - c0['relayouts']}; kernel launches a "
        f"round before the kernel fault {per_round[0]}, after "
        f"{per_round[-1]}; in all {launches}", flush=True)
    for what, good in ok.items():
        log(f"chaos leg: {what}: {'OK' if good else 'FAIL'}", flush=True)
    return {"ok": all(ok.values()), "checks": ok, "launches": launches,
            "want_launches": want, "guard": gs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_args(ap)
    args = ap.parse_args(argv)
    res = run(*model_from_args(args))
    print(f"chaos-smoke: {'OK' if res['ok'] else 'FAIL'}")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
