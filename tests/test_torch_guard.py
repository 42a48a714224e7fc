"""The port's FleetGuard, fault plan and session hooks, held to the port's
own solo runs.

Six of the reference's tests fail on the reference itself: the three of
``tests/test_guard.py`` (a survivor and a restored tenant bitwise equal
to solo runs), ``test_frontend.py::test_reserve_spares_are_bitwise_noops``
and two property tests of ``test_admission.py``. Their claims are
re-derived here on the port, where a tenant's rows in a cohort equal its
solo run's bit for bit on every tier on the CPU
(``tests/test_torch_session.py``):

- an injected NaN state is quarantined in the round it lands, and the
  cohort-mate equals a solo fleet that never had the sick tenant;
- a restore reloads the snapshot bit for bit and continues as a solo
  fleet stepped from it; with a journal it replays what the tenant missed
  and ends on the unfaulted twin's state;
- backoff and eviction follow the injected clock;
- an injected kernel fault moves the cohort one tier down (a lane move:
  one more relayout, states and quarantine flags carried); only
  ``KernelFault`` does: a real error inside the step propagates and the
  tier stays;
- the sentinel reduces over each tenant's rows, never the cohort's
  scratch row: a poisoned tenant in a cohort of 3 quarantines only it;
- a round that is not trace-sampled calls no fence;
- the admission audit log stays consistent over seeded attach/detach
  sequences, a ramp relays out only when a capacity class is exhausted,
  and spare slots leave every trajectory bit for bit unchanged.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import pipeline as pl, tgn
from repro_torch.data import stream
from repro_torch.data import temporal_graph as tgd
from repro_torch.kernels import ops
from repro_torch.obs import RoundTracer
from repro_torch.serving import session as sess
from repro_torch.serving.admission import AdmissionController
from repro_torch.serving.cluster import snapshot_tenant
from repro_torch.serving.faults import (FakeClock, Fault, FaultInjector,
                                        KernelFault)
from repro_torch.serving.guard import FleetGuard
from repro_torch.serving.journal import EventJournal
from repro_torch.serving.session import SessionManager

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def small_graph():
    return tgd.wikipedia_like(n_edges=500)


def _dims(g, f=16):
    return dict(n_nodes=g.cfg.n_nodes, n_edges=g.n_edges, f_edge=172,
                f_mem=f, f_time=f, f_emb=f, m_r=10)


def _make_mgr(g, use_kernels="ref", **kw):
    cfg = pl.variant_config("sat+lut+np4", **_dims(g))
    params = tgn.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    return SessionManager(params, g.edge_feats, model=cfg,
                          use_kernels=use_kernels, device="cpu", **kw)


def _rounds(g, i, batch=20, n=5):
    lo = 60 * i
    return list(stream.fixed_count(g, batch, window=slice(lo, lo + batch * n),
                                   seed=i))


def _poison(mgr, tid):
    st = mgr.state_of(tid)
    mgr.set_state(tid, st._replace(memory=torch.full_like(st.memory,
                                                          float("nan"))))


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_state_equal(a, b, msg=""):
    """Bit for bit (NaNs included)."""
    for f in a._fields:
        assert torch.equal(_bits(getattr(a, f)), _bits(getattr(b, f))), \
            f"{msg}: {f}"


def _solo(g, rounds, tier="ref", state=None):
    solo = _make_mgr(g, tier)
    t = solo.add_tenant()
    if state is not None:
        solo.set_state(t, state)
    for b in rounds:
        solo.step({t: b})
    return solo.state_of(t)


@pytest.mark.parametrize("tier", ["ref", "staged", "fused"])
def test_injected_nan_quarantines_and_survivor_is_bitwise(small_graph, tier):
    g = small_graph
    mgr = _make_mgr(g, tier)
    t0, t1 = mgr.add_tenant(), mgr.add_tenant()
    injector = FaultInjector([Fault(kind="nan_state", tenant=t1, at=1)])
    mgr.set_faults(injector)
    guard = FleetGuard(mgr, clock=FakeClock(), backoff_s=100.0,
                       backoff_cap_s=100.0)
    r0, r1 = _rounds(g, 0), _rounds(g, 1)
    for k in range(4):
        guard.step({t0: r0[k], t1: r1[k]})
    assert injector.pending() == [] and mgr.is_quarantined(t1)
    assert guard.quarantines == 1 and guard.restores == 0
    view = guard.tenant_view(t1)
    assert view["quarantined"] and view["last_reason"] == "nonfinite_state"
    assert view["next_attempt_in_s"] == pytest.approx(100.0)
    assert mgr.obs.counter("guard.quarantines").value == 1
    assert mgr.tenant_stats()[t1]["quarantined"]
    _assert_state_equal(mgr.state_of(t0), _solo(g, r0[:4], tier), "survivor")


@pytest.mark.parametrize("tier", ["ref", "fused"])
def test_auto_restore_resumes_bitwise_from_snapshot(small_graph, tmp_path,
                                                    tier):
    g = small_graph
    root = str(tmp_path / "snaps")
    mgr = _make_mgr(g, tier)
    t0, t1 = mgr.add_tenant(), mgr.add_tenant()
    clock = FakeClock()
    guard = FleetGuard(mgr, snapshot_root=root, clock=clock, backoff_s=1.0)
    r0, r1 = _rounds(g, 0), _rounds(g, 1)
    for k in range(2):
        guard.step({t0: r0[k], t1: r1[k]})
    snapshot_tenant(mgr, t1, root, step=2)
    good = mgr.state_of(t1)
    _poison(mgr, t1)
    guard.step({t0: r0[2], t1: r1[2]})          # detect + quarantine
    assert mgr.is_quarantined(t1)
    clock.advance(1.0)
    guard.step({t0: r0[3], t1: r1[3]})          # backoff due: restore
    assert not mgr.is_quarantined(t1) and guard.restores == 1
    assert guard.tenant_view(t1)["restores"] == 1
    _assert_state_equal(mgr.state_of(t1), good, "restored")
    guard.step({t0: r0[4], t1: r1[4]})
    _assert_state_equal(mgr.state_of(t1), _solo(g, [r1[4]], tier, good),
                        "resume")


def test_auto_restore_with_journal_is_lossless(small_graph, tmp_path):
    g = small_graph
    root = str(tmp_path / "snaps")
    journal = EventJournal(str(tmp_path / "wal"))
    mgr = _make_mgr(g, "staged")
    t0, t1 = mgr.add_tenant(), mgr.add_tenant()
    clock = FakeClock()
    guard = FleetGuard(mgr, snapshot_root=root, clock=clock, backoff_s=1.0,
                       journal=journal)
    r0, r1 = _rounds(g, 0, n=6), _rounds(g, 1, n=6)
    for k in range(2):
        journal.append_batch(t1, r1[k])
        guard.step({t0: r0[k], t1: r1[k]})
    snapshot_tenant(mgr, t1, root, step=2,
                    extra_meta={"journal": journal.cursor(t1)})
    _poison(mgr, t1)
    journal.append_batch(t1, r1[2])
    guard.step({t0: r0[2], t1: r1[2]})          # detect + quarantine
    journal.append_batch(t1, r1[3])
    guard.step({t0: r0[3], t1: r1[3]})          # outage round: dropped
    clock.advance(1.0)
    journal.append_batch(t1, r1[4])
    guard.step({t0: r0[4], t1: r1[4]})          # restore + replay 2..4
    assert not mgr.is_quarantined(t1) and guard.restores == 1
    journal.append_batch(t1, r1[5])
    guard.step({t0: r0[5], t1: r1[5]})
    _assert_state_equal(mgr.state_of(t1), _solo(g, r1, "staged"),
                        "lossless")
    _assert_state_equal(mgr.state_of(t0), _solo(g, r0, "staged"),
                        "survivor")


def test_backoff_schedule_and_eviction_are_deterministic(small_graph):
    g = small_graph
    mgr = _make_mgr(g)
    t0, t1 = mgr.add_tenant(), mgr.add_tenant()
    clock = FakeClock()
    guard = FleetGuard(mgr, clock=clock, max_restores=3, backoff_s=1.0)
    r0 = _rounds(g, 0, n=8)
    guard.step({t0: r0[0], t1: _rounds(g, 1, n=1)[0]})
    _poison(mgr, t1)
    guard.step({t0: r0[1]})                     # t = 0: quarantine
    assert mgr.is_quarantined(t1)
    clock.advance(0.5)
    guard.step({t0: r0[2]})
    assert guard._t[t1]["attempts"] == 0
    for t in (1.0, 3.0, 7.0):                   # due at 1, +2, +4
        clock.t = t
        guard.step({t0: r0[3]})
    assert guard._t[t1]["attempt_times"] == [1.0, 3.0, 7.0]
    assert guard.evictions == 1 and guard.restores == 0
    view = guard.tenant_view(t1)
    assert view["evicted"] and not view["quarantined"]
    assert "evicted after 3 failed restores" in view["last_reason"]
    assert t1 not in mgr.tenants and guard.snapshot()["evicted"] == [t1]
    assert not mgr.is_quarantined(t0)


@pytest.mark.parametrize("start,lower", [("fused", "staged"),
                                         ("staged", "ref")])
def test_kernel_fault_degrades_tier_in_one_relayout(small_graph, start,
                                                    lower):
    """A lane move: the cohort's tenants land one tier lower with their
    states bit for bit and their quarantine flags, in one more relayout,
    and the faulted round is retried; at ``ref`` the fault re-raises."""
    g = small_graph
    mgr = _make_mgr(g, start)
    t0, t1 = mgr.add_tenant(), mgr.add_tenant()
    injector = FaultInjector([Fault(kind="kernel_fail", tenant=t0, at=1)])
    mgr.set_faults(injector)
    guard = FleetGuard(mgr, clock=FakeClock(), backoff_s=100.0,
                       backoff_cap_s=100.0)
    r0, r1 = _rounds(g, 0), _rounds(g, 1)
    guard.step({t0: r0[0], t1: r1[0]})
    c0 = mgr.compile_counters()
    before = {t: mgr.state_of(t) for t in (t0, t1)}
    guard.quarantine(t1, reason="manual")       # must survive the move
    outs = guard.step({t0: r0[1], t1: r1[1]})
    assert injector.pending() == [] and t0 in outs
    assert guard.degradations == 1
    assert mgr.cohort_of(t0).tier == mgr.cohort_of(t1).tier == lower
    assert mgr.is_quarantined(t1)
    assert mgr.compile_counters()["relayouts"] == c0["relayouts"] + 1
    _assert_state_equal(mgr.state_of(t1), before[t1], "carried")
    _assert_state_equal(mgr.state_of(t0),
                        _solo(g, [r0[1]], lower, before[t0]), "retried")
    if lower == "ref":
        mgr.set_faults(FaultInjector(
            [Fault(kind="kernel_fail", tenant=t0, at=0)]))
        with pytest.raises(KernelFault):
            guard.step({t0: r0[2]})


@pytest.mark.parametrize("where", ["fused_step", "gru_cell"])
def test_real_kernel_error_propagates_and_keeps_the_tier(small_graph,
                                                         monkeypatch, where):
    """Only an injected ``KernelFault`` degrades: an error raised inside
    a kernel entry point (a CUDA error, a failed build) propagates out of
    ``guard.step``, and the cohort stays on its tier."""
    g = small_graph
    tier = "fused" if where == "fused_step" else "staged"
    mgr = _make_mgr(g, tier)
    t0 = mgr.add_tenant()
    mgr.set_faults(FaultInjector([]))           # an armed, empty plan
    guard = FleetGuard(mgr, clock=FakeClock())
    r0 = _rounds(g, 0)
    guard.step({t0: r0[0]})
    c0 = mgr.compile_counters()

    def broken(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(ops, where, broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        guard.step({t0: r0[1]})
    assert mgr.cohort_of(t0).tier == tier
    assert guard.degradations == 0
    assert mgr.compile_counters()["relayouts"] == c0["relayouts"]


def test_sentinel_quarantines_only_the_poisoned_tenant(small_graph):
    """A cohort of 3 (a spare slot too): NaN in tenant 1's memory, and in
    the scratch row that takes every tenant's losers and padding writes.
    The sentinel flags tenant 1 only."""
    g = small_graph
    mgr = _make_mgr(g, "fused", reserve=True)
    tids = [mgr.add_tenant() for _ in range(3)]
    guard = FleetGuard(mgr, clock=FakeClock(), backoff_s=100.0,
                       backoff_cap_s=100.0)
    rs = [_rounds(g, i) for i in range(3)]
    guard.step({t: rs[i][0] for i, t in enumerate(tids)})
    cohort = mgr.cohort_of(tids[0])
    assert cohort.capacity == 4
    V = cohort.cfg.n_nodes
    assert cohort.state.memory.shape[0] == cohort.capacity * V + 1
    cohort.state.memory[-1] = float("nan")      # the scratch row
    cohort.state.last_update[-1] = float("inf")
    assert cohort.finite_slots().tolist() == [True] * 4
    _poison(mgr, tids[1])
    assert cohort.finite_slots().tolist() == [True, False, True, True]
    guard.step({t: rs[i][1] for i, t in enumerate(tids)})
    assert mgr.quarantined == {tids[1]} and guard.quarantines == 1


def test_unsampled_rounds_call_no_fence(small_graph, monkeypatch):
    """The session fences the device only on trace-sampled rounds: one
    fence for the super-batch's copy (``h2d``) and one for the round's
    commits (``drain``)."""
    g = small_graph
    calls = []
    real = sess._fence
    monkeypatch.setattr(sess, "_fence", lambda m: (calls.append(m),
                                                   real(m)))
    mgr = _make_mgr(g, "fused")
    t0, t1 = mgr.add_tenant(), mgr.add_tenant()
    r0, r1 = _rounds(g, 0, n=9), _rounds(g, 1, n=9)
    for k in range(3):                          # no tracer: no fence
        mgr.step({t0: r0[k], t1: r1[k]})
    assert calls == []
    tracer = RoundTracer(clock=FakeClock(), sample_every=4)
    mgr.set_tracer(tracer)
    for k in range(3, 9):
        n = len(calls)
        sampled = tracer.would_sample()
        mgr.step({t0: r0[k], t1: r1[k]})
        assert len(calls) - n == (2 if sampled else 0), k
    assert tracer.rounds_sampled == 2 and len(calls) == 4
    assert [s.name for s in tracer.spans].count("drain") == 2


def test_slo_burn_covers_the_outage_window(small_graph):
    g = small_graph
    mgr = _make_mgr(g)
    t0, t1 = mgr.add_tenant(), mgr.add_tenant()
    mgr.set_slo(25.0)
    guard = FleetGuard(mgr, clock=FakeClock(), backoff_s=100.0,
                       backoff_cap_s=100.0)
    r0 = _rounds(g, 0)
    guard.quarantine(t1, reason="manual")
    before = mgr.slo.tenant(t1)
    for k in range(3):
        guard.step({t0: r0[k]})
    after = mgr.slo.tenant(t1)
    assert after["violations"] == before["violations"] + 3
    assert after["events"] == before["events"] + 3
    assert after["burn_rate"] > 0.0
    assert mgr.slo.tenant(t0)["violations"] == 0
    summary = mgr.summary()
    assert summary["per_tenant"][t0]["slo"]["events"] > 0  # round walls


def test_poison_batch_and_quarantined_ingest(small_graph):
    """A poisoned batch (NaN timestamps past ingest) is caught by the
    sentinel; the quarantined tenant's rounds are dropped, so its state
    holds while its cohort-mate serves on."""
    g = small_graph
    mgr = _make_mgr(g, "staged")
    t0, t1 = mgr.add_tenant(), mgr.add_tenant()
    mgr.set_faults(FaultInjector([Fault(kind="poison_batch", tenant=t1,
                                        at=1)]))
    guard = FleetGuard(mgr, clock=FakeClock(), backoff_s=100.0,
                       backoff_cap_s=100.0)
    r0, r1 = _rounds(g, 0), _rounds(g, 1)
    for k in range(2):
        guard.step({t0: r0[k], t1: r1[k]})
    assert mgr.quarantined == {t1}
    held = mgr.state_of(t1)
    outs = guard.step({t0: r0[2], t1: r1[2]})
    assert set(outs) == {t0}
    _assert_state_equal(mgr.state_of(t1), held, "held")
    assert not all(torch.isfinite(t).all() for t in held
                   if t.is_floating_point())       # NaN timestamps


def test_admission_controller_audits_fast_and_slow_paths(small_graph):
    g = small_graph
    mgr = _make_mgr(g, reserve=True)
    adm = AdmissionController(mgr)
    a = adm.attach()                      # new cohort: relayout
    assert not adm.log[-1].fast
    b = adm.attach()                      # lands in the spare slot
    assert adm.log[-1].fast and adm.log[-1].capacity == 2
    c = adm.attach()                      # class exhausted: relayout to 4
    assert not adm.log[-1].fast and adm.log[-1].capacity == 4
    for tid in (c, b):
        adm.detach(tid)
        assert adm.log[-1].fast
    adm.prewarm("sat+lut+np4+reservoir")
    s = adm.stats()
    assert s["fast"] == 3 and s["relayouts"] == 3
    assert [(c["size"], c["capacity"], c["spare"]) for c in s["cohorts"]] \
        == [(1, 4, 3), (0, 2, 2)]
    assert mgr.cohort_of(a).size == 1
    with pytest.raises(ValueError):
        AdmissionController(_make_mgr(g))


# ---------------------------------------------------------------------------
# the reference's admission and reserve claims, re-derived on the port
# ---------------------------------------------------------------------------

_VARIANTS = ("sat+lut+np4", "sat+lut+np2", "sat+lut+np4+uniform")


@pytest.mark.parametrize("seed", range(4))
def test_audit_log_consistent_under_random_sequences(small_graph, seed):
    """A seeded attach/detach sequence: one record an operation, ``fast``
    exactly when neither relayout nor new cohort, sizes and capacities
    those of the live cohort, the ladder's headroom after a relayout, and
    the ledger balancing the live tenants."""
    rng = np.random.RandomState(seed)
    mgr = _make_mgr(small_graph, reserve=True)
    adm = AdmissionController(mgr)
    live, performed = [], 0
    for _ in range(10):
        op, i = rng.randint(2), rng.randint(3)
        if op == 0:
            tid = adm.attach(_VARIANTS[i])
            live.append(tid)
            rec, cohort = adm.log[-1], mgr.cohort_of(tid)
            assert rec.action == "attach" and rec.tid == tid
            assert (rec.size, rec.capacity) == (cohort.size, cohort.capacity)
            assert rec.fast == (not (rec.relayout or rec.new_cohort))
            if rec.relayout or rec.new_cohort:
                assert rec.capacity == mgr.reserve.capacity_for(rec.size)
            else:
                assert rec.capacity >= rec.size
        elif live:
            tid = live.pop(i % len(live))
            rec = adm.detach(tid)
            assert rec.action == "detach" and rec.fast and not rec.relayout
        else:
            continue
        performed += 1
        assert len(adm.log) == performed and len(mgr.tenants) == len(live)
    s = adm.stats()
    assert s["admissions"] == performed
    assert s["fast"] == sum(a.fast for a in adm.log)
    assert s["relayouts"] == sum(a.relayout for a in adm.log)
    assert sum(c["size"] for c in s["cohorts"]) == len(live)
    assert all(0 <= c["size"] <= c["capacity"] for c in s["cohorts"])


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 9])
def test_relayout_cadence_is_logarithmic(small_graph, n):
    """A ramp of one cohort from 0 to n tenants relays out only when its
    class is exhausted."""
    mgr = _make_mgr(small_graph, reserve=True)
    adm = AdmissionController(mgr)
    for _ in range(n):
        adm.attach(_VARIANTS[0])
    cap, slow = 0, 0
    for k in range(1, n + 1):
        if k > cap:
            cap, slow = mgr.reserve.capacity_for(k), slow + 1
    assert sum(a.relayout or a.new_cohort for a in adm.log) == slow
    assert sum(a.fast for a in adm.log) == n - slow


@pytest.mark.parametrize("tier", ["ref", "staged", "fused"])
def test_reserve_spares_are_bitwise_noops(small_graph, tier):
    """A reserve fleet (idle spare slots in every cohort) serves the same
    trajectories as the exact-size session, bit for bit."""
    g = small_graph
    mgr_r = _make_mgr(g, tier, reserve=True)
    mgr_l = _make_mgr(g, tier)
    pairs = [(mgr_r.add_tenant(v), mgr_l.add_tenant(v))
             for v in (None, "sat+lut+np4+reservoir")]
    feeds = [_rounds(g, i) for i in range(len(pairs))]
    for k in range(5):
        outs_r = mgr_r.step({r: feeds[i][k] for i, (r, _) in enumerate(pairs)})
        outs_l = mgr_l.step({l: feeds[i][k] for i, (_, l) in enumerate(pairs)})
        for r, l in pairs:
            assert torch.equal(outs_r[r].emb_src, outs_l[l].emb_src)
    for r, l in pairs:
        assert mgr_r.cohort_of(r).spare > 0
        _assert_state_equal(mgr_r.state_of(r), mgr_l.state_of(l), r)
