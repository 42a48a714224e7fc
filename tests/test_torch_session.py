"""The port's multi-tenant session: a fleet of tenant streams, each kernel
run once per cohort over the stacked rows of all its tenants.

Within the port (CPU, where every kernel entry point runs its plain
version): N tenants in a session equal N streams served alone, bit for
bit, on the ref tier and on the staged and fused tiers; the coalesced
round equals the per-cohort baseline bit for bit; idle tenants stay
frozen; ragged batches, mid-stream adds, removals, reserve-mode admission
and parameter sets behave as the reference's (``tests/test_session.py``,
whose cases these port).

Against the JAX package: the same seeded batches go to the reference's
``SessionManager`` (its kernel tiers in interpret mode, as its own tests
run them) and to the port's session, three tenants on mixed lanes (np4,
np4 + reservoir, the teacher on its own parameter set). Integer and bool
tables must be equal. Floats are fp32 on both sides but summed in other
orders by different libraries: the first round, from the same initial
state, is held to STEP_TOL (rtol = atol = 1e-5); later rounds feed on
each side's own state and the GRU carries the rounding forward, so
TRAJ_TOL (1e-4), as in ``tests/test_torch_trajectory.py``.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as jpl
from repro.core import tgn as jtgn
from repro.serving.session import SessionManager as JSessionManager

from repro_torch import convert
from repro_torch.core import mailbox, stages, tgn
from repro_torch.core import pipeline as tpl
from repro_torch.data import stream, temporal_graph as tgd
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.serving import session as sess
from repro_torch.serving.admission import CapacityLadder
from repro_torch.serving.engine import StreamingEngine
from repro_torch.serving.session import SessionManager

torch.set_num_threads(1)

N_TENANTS = 3
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)
OUT_FIELDS = ("emb_src", "emb_dst", "attn_logits", "nbr_valid", "nbr_dt")


@pytest.fixture(scope="module")
def small_graph():
    return tgd.wikipedia_like(n_edges=500)


def _dims(g, f=8):
    return dict(n_nodes=g.cfg.n_nodes, n_edges=g.n_edges, f_edge=172,
                f_mem=f, f_time=f, f_emb=f, m_r=10)


def _params(cfg, seed):
    return tgn.init_params(torch.Generator().manual_seed(seed), cfg, "cpu")


def _session(params, g, cfg, **kw):
    return SessionManager(params, g.edge_feats, model=cfg, device="cpu", **kw)


def _engine(variant, params, g, dims, tier="ref"):
    return StreamingEngine.from_variant(variant, params, g.edge_feats,
                                        use_kernels=tier, device="cpu",
                                        **dims)


def _tenant_stream(g, i, batch=40, rounds=4):
    """Tenant i replays its own window of the graph (independent streams
    over overlapping vertex populations)."""
    lo = 60 * i
    return stream.fixed_count(g, batch, window=slice(lo, lo + batch * rounds),
                              seed=i)


def _assert_state_equal(a, b, msg=""):
    for f in mailbox.VertexState._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f"{msg}: {f}"


def _assert_out_equal(a, b, msg=""):
    for f in OUT_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f"{msg}: {f}"


# ---------------------------------------------------------------------------
# N tenants == N streams served alone, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant,tier", [("teacher", "ref"),
                                          ("sat+lut+np4", "ref"),
                                          ("sat+lut+np4", "staged"),
                                          ("sat+lut+np4", "fused")])
def test_multitenant_bitwise_matches_sequential_engines(small_graph, variant,
                                                        tier):
    g = small_graph
    dims = _dims(g)
    cfg = tpl.variant_config(variant, **dims)
    params = _params(cfg, 0)
    mgr = _session(params, g, cfg, use_kernels=tier)
    tids = [mgr.add_tenant() for _ in range(N_TENANTS)]
    assert mgr.cohort_of(tids[0]).tier == stages.resolved_tier(cfg, tier)
    embs = {t: [] for t in tids}
    for _batches, outs in mgr.run({t: _tenant_stream(g, i)
                                   for i, t in enumerate(tids)}):
        for t, o in outs.items():
            embs[t].append((o.emb_src, o.emb_dst))
    for i, t in enumerate(tids):
        eng = _engine(variant, params, g, dims, tier)
        for r, batch in enumerate(_tenant_stream(g, i)):
            hs, hd = eng.process(batch)
            assert torch.equal(embs[t][r][0], hs), f"{t} round {r} src"
            assert torch.equal(embs[t][r][1], hd), f"{t} round {r} dst"
        _assert_state_equal(mgr.state_of(t), eng.state, msg=t)


def test_mixed_sampler_cohorts_each_match_their_engine(small_graph):
    g = small_graph
    dims = _dims(g)
    variants = ("sat+lut+np4", "sat+lut+np4+uniform", "sat+lut+np4+reservoir",
                "sat+lut+np4+reservoir")   # two reservoirs: one 2-cohort
    cfg = tpl.variant_config("sat+lut+np4", **dims)
    params = _params(cfg, 1)
    mgr = _session(params, g, cfg)
    tids = [mgr.add_tenant(v) for v in variants]
    assert len(mgr.describe()) == 3
    for _b, _o in mgr.run({t: _tenant_stream(g, i)
                           for i, t in enumerate(tids)}):
        pass
    assert mgr.metrics[-1]["launches"] == 1
    finals = []
    for i, (t, v) in enumerate(zip(tids, variants)):
        eng = _engine(v, params, g, dims)
        for batch in _tenant_stream(g, i):
            eng.process(batch)
        _assert_state_equal(mgr.state_of(t), eng.state, msg=v)
        finals.append(mgr.state_of(t).memory)
    # the sampler is load-bearing: other policies, other states
    assert not torch.equal(finals[0], finals[1])


@pytest.mark.parametrize("tier", ["ref", "fused"])
def test_hot_vertex_and_padding_never_cross_tenants(small_graph, tier):
    """The same vertex is hot in every tenant (more than m_r inserts a
    batch, so ring slots wrap and last-write-wins races), and every
    tenant's padding rows name that vertex too: in a flattened cohort of 3
    no race and no padding row reaches another tenant's rows. Each tenant
    equals its solo run bit for bit, an idle tenant stays frozen, and the
    stacked tables change nowhere outside the active tenants' rows but the
    scratch row."""
    g = small_graph
    dims = _dims(g)
    V = dims["n_nodes"]
    cfg = tpl.variant_config("sat+lut+np4", **dims)
    params = _params(cfg, 5)
    rng = np.random.RandomState(0)

    def batch(i, r, B=16):
        src = np.where(rng.rand(B) < 0.75, 7, rng.randint(0, V, B))
        dst = np.where(rng.rand(B) < 0.5, 7, rng.randint(0, V, B))
        valid = np.arange(B) < B - 4 - i
        src[~valid] = dst[~valid] = 7          # padding names the hot id
        ts = (100.0 * r + np.sort(rng.rand(B)) + i).astype(np.float32)
        return stream.EdgeBatch(
            src=src.astype(np.int32), dst=dst.astype(np.int32),
            eid=rng.randint(0, g.n_edges, B).astype(np.int32), ts=ts,
            valid=valid, neg_dst=np.zeros(B, np.int32))

    feeds = [[batch(i, r) for r in range(3)] for i in range(3)]
    mgr = _session(params, g, cfg, use_kernels=tier)
    tids = [mgr.add_tenant() for _ in range(3)]
    cohort = mgr.cohort_of(tids[0])
    solos = [_session(params, g, cfg, use_kernels=tier) for _ in range(3)]
    solo_t = [s.add_tenant() for s in solos]
    frozen = None
    for r in range(3):
        active = [0, 1] if r == 1 else [0, 1, 2]   # tenant 2 idles round 1
        if r == 1:
            frozen = mgr.state_of(tids[2])
            before = mailbox.VertexState(*(t.clone() for t in cohort.state))
        outs = mgr.step({tids[i]: feeds[i][r] for i in active})
        for i in active:
            o = solos[i].step({solo_t[i]: feeds[i][r]})[solo_t[i]]
            _assert_out_equal(outs[tids[i]], o, f"round {r} tenant {i}")
        if r == 1:
            _assert_state_equal(mgr.state_of(tids[2]), frozen, "idle")
            for a, b in zip(cohort.state, before):
                assert torch.equal(a[2 * V:3 * V], b[2 * V:3 * V])
    for i in range(3):
        st = mgr.state_of(tids[i])
        _assert_state_equal(st, solos[i].state_of(solo_t[i]), f"tenant {i}")
        assert int(st.nbr_cursor[7]) > cfg.m_r     # the ring wrapped
        assert st.mail_valid[7]


def test_stager_reuse_gate_includes_the_consuming_launch(small_graph,
                                                         monkeypatch):
    """A staging set is refilled only after the event recorded AFTER the
    launches that consumed it, two rounds earlier, has been waited on."""
    g = small_graph
    dims = _dims(g)
    cfg = tpl.variant_config("sat+lut+np4", **dims)
    log = []

    class Ev:
        def __init__(self, tag):
            self.tag = tag

        def synchronize(self):
            log.append(("wait", self.tag))

    def event(self):
        n = sum(1 for e in log if e[0] == "event")
        log.append(("event", n))
        return Ev(n)

    launch = tpl.CoalescedRound.__call__

    def logged_launch(self, *a, **kw):
        log.append(("launch",))
        return launch(self, *a, **kw)

    monkeypatch.setattr(sess._HostStager, "_event", event)
    monkeypatch.setattr(tpl.CoalescedRound, "__call__", logged_launch)
    mgr = _session(_params(cfg, 0), g, cfg)
    t0 = mgr.add_tenant()
    for batch in _tenant_stream(g, 0, batch=20, rounds=4):
        mgr.step({t0: batch})
    # a round: the copy's event, the launch, the consumer's event; from
    # round 2 on, each round first waits on round k-2's consumer event
    want = []
    for k in range(4):
        if k >= 2:
            want.append(("wait", 2 * (k - 2) + 1))
        want += [("event", 2 * k), ("launch",), ("event", 2 * k + 1)]
    assert log == want


def test_idle_tenants_are_bitwise_frozen(small_graph):
    g = small_graph
    dims = _dims(g)
    cfg = tpl.variant_config("sat+lut+np4", **dims)
    params = _params(cfg, 2)
    mgr = _session(params, g, cfg)
    a, b = mgr.add_tenant(), mgr.add_tenant()
    batches = list(_tenant_stream(g, 0, rounds=2))
    mgr.step({a: batches[0], b: batches[0]})
    frozen = mgr.state_of(b)
    out = mgr.step({a: batches[1]})          # b idles this round
    assert set(out) == {a}
    _assert_state_equal(mgr.state_of(b), frozen, msg="idle tenant")
    eng = _engine("sat+lut+np4", params, g, dims)
    for batch in batches:
        eng.process(batch)
    _assert_state_equal(mgr.state_of(a), eng.state, msg="active tenant")


def test_add_tenant_midstream_and_ragged_batches(small_graph):
    g = small_graph
    dims = _dims(g)
    cfg = tpl.variant_config("sat+lut+np4", **dims)
    params = _params(cfg, 3)
    mgr = _session(params, g, cfg)
    a = mgr.add_tenant()
    for batch in _tenant_stream(g, 0, rounds=2):
        mgr.step({a: batch})
    b = mgr.add_tenant()                     # cohort grows mid-serving
    small = next(stream.fixed_count(g, 24, window=slice(0, 24)))
    big = next(stream.fixed_count(g, 40, window=slice(80, 120), seed=7))
    outs = mgr.step({b: small, a: big})      # ragged round: 24 vs 40
    assert outs[b].emb_src.shape[0] == 24
    assert outs[b].attn_logits.shape[0] == 48
    assert outs[a].emb_src.shape[0] == 40
    eng = _engine("sat+lut+np4", params, g, dims)
    hs, _hd = eng.process(small)
    assert torch.equal(outs[b].emb_src, hs)
    _assert_state_equal(mgr.state_of(b), eng.state, msg="late tenant")


def test_kernel_backends_serve_multitenant(small_graph):
    """The staged and fused tiers' cohort step agrees with the ref tier's
    within the kernels' tolerance (their plain versions here)."""
    g = small_graph
    dims = _dims(g)
    cfg = tpl.variant_config("sat+lut+np4", **dims)
    params = _params(cfg, 4)
    mem = {}
    for tier in ("ref", "staged", "fused"):
        mgr = _session(params, g, cfg, use_kernels=tier)
        tids = [mgr.add_tenant() for _ in range(2)]
        for _b, _o in mgr.run({t: _tenant_stream(g, i, rounds=2)
                               for i, t in enumerate(tids)}):
            pass
        mem[tier] = [mgr.state_of(t).memory for t in tids]
    for tier in ("staged", "fused"):
        for mk, mr in zip(mem[tier], mem["ref"]):
            torch.testing.assert_close(mk, mr, rtol=0, atol=2e-5)


def test_remove_tenant_releases_slots_eagerly(small_graph):
    g = small_graph
    dims = _dims(g)
    V = dims["n_nodes"]
    cfg = tpl.variant_config("sat+lut+np4", **dims)
    mgr = _session(_params(cfg, 6), g, cfg)
    tids = [mgr.add_tenant() for _ in range(4)]
    cohort = mgr.cohort_of(tids[0])
    batches = list(_tenant_stream(g, 0, rounds=2))
    mgr.step({t: batches[0] for t in tids})
    assert cohort.capacity == 4 and cohort.state.memory.shape[0] == 4 * V + 1
    survivors = {t: mgr.state_of(t) for t in tids if t != tids[1]}
    mgr.remove_tenant(tids[1])               # middle slot: indices shift
    assert cohort.capacity == 3 and cohort.state.memory.shape[0] == 3 * V + 1
    for t, st in survivors.items():
        _assert_state_equal(st, mgr.state_of(t), msg=f"survivor {t}")
    with pytest.raises(KeyError):
        mgr.state_of(tids[1])
    mgr.set_state(tids[2], survivors[tids[0]])
    _assert_state_equal(mgr.state_of(tids[2]), survivors[tids[0]],
                        msg="set_state after remove")
    out = mgr.step({t: batches[1] for t in survivors})
    assert set(out) == set(survivors)
    for t in survivors:
        mgr.remove_tenant(t)
    assert mgr.tenants == () and cohort.state is None
    assert cohort.capacity == 0


def test_remove_tenant_drains_inflight_rounds(small_graph):
    g = small_graph
    dims = _dims(g)
    cfg = tpl.variant_config("sat+lut+np4", **dims)
    params = _params(cfg, 7)
    mgr = _session(params, g, cfg)
    tids = [mgr.add_tenant() for _ in range(3)]
    its = {t: iter(_tenant_stream(g, i, rounds=2))
           for i, t in enumerate(tids)}
    for _ in range(2):
        mgr.step({t: next(it) for t, it in its.items()})
    order = []
    cohort = mgr.cohort_of(tids[1])
    orig_sync, orig_remove = mgr.sync, cohort.remove
    mgr.sync = lambda: (order.append("drain"), orig_sync())[-1]
    cohort.remove = lambda t: (order.append("release"), orig_remove(t))[-1]
    mgr.remove_tenant(tids[1])
    mgr.sync, cohort.remove = orig_sync, orig_remove
    assert order == ["drain", "release"]
    for i in (0, 2):
        eng = _engine("sat+lut+np4", params, g, dims)
        for batch in _tenant_stream(g, i, rounds=2):
            eng.process(batch)
        _assert_state_equal(mgr.state_of(tids[i]), eng.state,
                            msg=f"survivor {i}")


def test_tenant_lifecycle_and_errors(small_graph):
    g = small_graph
    dims = _dims(g)
    cfg = tpl.variant_config("sat+lut+np4", **dims)
    mgr = _session(_params(cfg, 5), g, cfg)
    a = mgr.add_tenant(name="fraud-eu")
    assert mgr.tenants == ("fraud-eu",)
    with pytest.raises(ValueError, match="already exists"):
        mgr.add_tenant(name="fraud-eu")
    with pytest.raises(ValueError, match="shares sat\\+lut parameters"):
        mgr.add_tenant("teacher")
    b = mgr.add_tenant("sat+lut+np4+reservoir", reservoir_tau=3600.0)
    assert "tau=3600" in mgr.cohort_of(b).pipeline.describe()["sampler"]
    c = mgr.add_tenant("sat+lut+np4+reservoir", reservoir_tau=60.0)
    taus = {k: v for k, v in mgr.describe().items() if "reservoir" in k}
    assert len(taus) == 2 and any(k.endswith("@tau=60") for k in taus)
    assert {t for v in taus.values() for t in v["tenants"]} == {b, c}
    # the lane table: one lane a stage program (tau is baked in)
    lanes = {mgr.cohort_of(t).pipeline.stages.variant_id for t in (a, b, c)}
    assert len(lanes) == 3
    mgr.remove_tenant(c)
    with pytest.raises(KeyError, match="unknown tenants"):
        mgr.step({"nope": next(_tenant_stream(g, 0))})
    mgr.remove_tenant(a)
    assert mgr.tenants == (b,)
    assert set(mgr.step({b: next(_tenant_stream(g, 0))})) == {b}


def test_variant_lane_is_the_resolved_stage_program(small_graph):
    dims = _dims(small_graph)
    cfg = tpl.variant_config("sat+lut+np4", **dims)
    lane = stages.variant_lane
    assert lane(cfg, "staged") == lane(cfg.replace(n_nodes=7), "staged")
    assert lane(cfg, "staged") != lane(cfg, "fused")
    assert lane(cfg, True) == lane(cfg, "staged")
    teacher = tpl.variant_config("teacher", **dims)
    assert lane(teacher, "fused") == lane(teacher, "staged")   # resolved
    res = cfg.replace(sampler="reservoir")
    assert lane(res) != lane(res.replace(reservoir_tau=60.0))
    assert lane(cfg) == lane(cfg.replace(reservoir_tau=60.0))  # recent
    pipe = tpl.build_pipeline(cfg, "fused", device="cpu")
    assert pipe.describe()["lane"] == pipe.stages.variant_id == lane(cfg,
                                                                     "fused")


# ---------------------------------------------------------------------------
# the coalesced round
# ---------------------------------------------------------------------------

MIXED_VARIANTS = ("sat+lut+np4", "sat+lut+np2", "sat+lut+np4+reservoir")


def _mixed_fleet(g, params, cfg, n_tenants, coalesce, tier="ref"):
    mgr = _session(params, g, cfg, use_kernels=tier, coalesce=coalesce)
    tids = [mgr.add_tenant(MIXED_VARIANTS[i % len(MIXED_VARIANTS)])
            for i in range(n_tenants)]
    return mgr, tids


@pytest.mark.parametrize("tier", ["ref", "fused"])
def test_coalesced_bitwise_matches_percohort_mixed_cohorts(small_graph,
                                                           tier):
    g = small_graph
    dims = _dims(g)
    cfg = tpl.variant_config("sat+lut+np4", **dims)
    params = _params(cfg, 7)
    m1, t1 = _mixed_fleet(g, params, cfg, 8, True, tier)
    m2, t2 = _mixed_fleet(g, params, cfg, 8, False, tier)
    assert len(m1.describe()) == 3
    for r, width in enumerate((40, 24, 40, 8)):   # stager width grows
        batches = {}
        for i in range(8):
            if r == 2 and i % 4 == 1:            # some tenants idle
                continue
            lo = 50 * i + r * width
            batches[i] = next(stream.fixed_count(
                g, width, window=slice(lo, lo + width), seed=i))
        o1 = m1.step({t1[i]: b for i, b in batches.items()})
        o2 = m2.step({t2[i]: b for i, b in batches.items()})
        assert set(o1) == {t1[i] for i in batches}
        for i in batches:
            _assert_out_equal(o1[t1[i]], o2[t2[i]], f"round {r} tenant {i}")
    for a, b in zip(t1, t2):
        _assert_state_equal(m1.state_of(a), m2.state_of(b), msg=a)


def test_coalesced_round_is_one_call_with_each_kernel_once_a_cohort(
        small_graph, monkeypatch):
    """Every coalesced ``step`` issues one round call whatever the number
    of cohorts (the baseline: one launch a cohort), and inside it each
    kernel entry point runs once per cohort of its lane, over the stacked
    rows of all that cohort's tenants."""
    g = small_graph
    dims = _dims(g)
    cfg = tpl.variant_config("sat+lut+np4", **dims)
    params = _params(cfg, 8)
    rows = {n: [] for n in ("lut_encode", "gru_cell", "sat_aggregate",
                            "fused_step")}
    for name, rows_of in (("lut_encode", lambda a: a[0].numel()),
                          ("gru_cell", lambda a: a[0].shape[0]),
                          ("sat_aggregate", lambda a: a[0].shape[0]),
                          ("fused_step", lambda a: a[0].shape[0])):
        def spy(*a, _f=getattr(ops, name), _n=name, _r=rows_of, **kw):
            rows[_n].append(_r(a))
            return _f(*a, **kw)
        monkeypatch.setattr(ops, name, spy)
    # 6 tenants: 2 fused np4, 2 staged np4, 2 fused np2
    m1 = _session(params, g, cfg, coalesce=True)
    m2 = _session(params, g, cfg, coalesce=False)
    lanes = [(None, "fused"), (None, "staged"), ("sat+lut+np2", "fused")] * 2
    t1 = [m1.add_tenant(v, use_kernels=k) for v, k in lanes]
    t2 = [m2.add_tenant(v, use_kernels=k) for v, k in lanes]
    feeds = {i: list(_tenant_stream(g, i, batch=20, rounds=3))
             for i in range(6)}
    for r in range(3):
        before = m1._coalesced.calls if m1._coalesced is not None else 0
        for n in rows:
            rows[n].clear()
        m1.step({t1[i]: feeds[i][r] for i in range(6)})
        assert m1._coalesced.calls == before + 1
        assert m1.metrics[-1]["launches"] == 1
        # two fused cohorts, one staged: each of 2 tenants x 2B rows
        assert rows == {"lut_encode": [80], "gru_cell": [80],
                        "sat_aggregate": [80], "fused_step": [80, 80]}
        m2.step({t2[i]: feeds[i][r] for i in range(6)})
        assert m2.metrics[-1]["launches"] == 3
    assert m1._coalesced.rows == 6
    assert len({p.stages.variant_id for p, _, _ in m1._coalesced.parts}) == 3
    for a, b in zip(t1, t2):
        _assert_state_equal(m1.state_of(a), m2.state_of(b), msg=a)
    a1 = m1.add_tenant("sat+lut+np2", use_kernels="fused")
    assert m1._coalesced is None                   # layout invalidated
    b = next(_tenant_stream(g, 6))
    m1.step({a1: b})
    assert m1.metrics[-1]["launches"] == 1 and m1._coalesced.rows == 7


def test_mixed_kernel_tier_fleet_replays_bitwise(small_graph):
    g = small_graph
    dims = _dims(g)
    cfg = tpl.variant_config("sat+lut+np4", **dims)
    params = _params(cfg, 11)
    lanes = ((None, "fused"), (None, "staged"),
             ("sat+lut+np4+reservoir", "fused"))

    def fleet(coalesce):
        mgr = _session(params, g, cfg, use_kernels="staged",
                       coalesce=coalesce)
        return mgr, [mgr.add_tenant(v, use_kernels=t) for v, t in lanes]

    m1, t1 = fleet(True)
    m2, t2 = fleet(False)
    assert len(m1.describe()) == 3
    assert {c.tier for c in m1._cohorts.values()} == {"fused", "staged"}
    solos = []
    for v, t in lanes:
        m = _session(params, g, cfg, use_kernels="staged")
        solos.append((m, m.add_tenant(v, use_kernels=t)))
    feeds = [list(_tenant_stream(g, i, batch=30, rounds=4)) for i in range(3)]
    for r, w in enumerate((30, 18, 30, 30)):          # round 1 ragged
        batches = {}
        for i in range(3):
            if r == 2 and i == 1:                     # staged lane idles
                continue
            b = feeds[i][r]
            batches[i] = b._replace(src=b.src[:w], dst=b.dst[:w],
                                    eid=b.eid[:w], ts=b.ts[:w],
                                    valid=b.valid[:w], neg_dst=b.neg_dst[:w])
        o1 = m1.step({t1[i]: b for i, b in batches.items()})
        o2 = m2.step({t2[i]: b for i, b in batches.items()})
        assert m1.metrics[-1]["launches"] == 1
        for i, b in batches.items():
            sm, st = solos[i]
            o3 = sm.step({st: b})[st]
            _assert_out_equal(o1[t1[i]], o2[t2[i]], f"r{r} lane {i} cohort")
            _assert_out_equal(o1[t1[i]], o3, f"r{r} lane {i} solo")
    for i in range(3):
        sm, st = solos[i]
        _assert_state_equal(m1.state_of(t1[i]), m2.state_of(t2[i]),
                            msg=f"lane {i} coalesced-vs-percohort")
        _assert_state_equal(m1.state_of(t1[i]), sm.state_of(st),
                            msg=f"lane {i} coalesced-vs-solo")


# (variant, param-set name or None = the default set)
MODEL_LANES = (("sat+lut+np4", None), ("teacher", "teacher-v1"),
               ("sat+lut+np4", "student-B"))


def _model_fleet_params(g):
    dims = _dims(g)
    cfg = tpl.variant_config("sat+lut+np4", **dims)
    tcfg = tpl.variant_config("teacher", **dims)
    return cfg, tcfg, {None: _params(cfg, 20),
                       "teacher-v1": _params(tcfg, 21),
                       "student-B": _params(cfg, 22)}


@pytest.mark.parametrize("coalesce", [True, False])
def test_mixed_model_fleet_replays_bitwise(small_graph, coalesce):
    """A teacher lane and two student lanes on three parameter sets equal
    three separate one-model sessions bit for bit."""
    g = small_graph
    cfg, tcfg, psets = _model_fleet_params(g)
    mgr = _session(psets[None], g, cfg, coalesce=coalesce)
    mgr.register_params("teacher-v1", psets["teacher-v1"])
    mgr.register_params("student-B", psets["student-B"])
    tids = [mgr.add_tenant(v, params=p) for v, p in MODEL_LANES]
    assert len(mgr.describe()) == 3
    assert any(k.endswith("@params=student-B") for k in mgr.describe())
    feeds = {t: list(_tenant_stream(g, i)) for i, t in enumerate(tids)}
    traj = {t: [] for t in tids}
    for r in range(4):
        outs = mgr.step({t: feeds[t][r] for t in tids})
        for t in tids:
            traj[t].append(outs[t].emb_src)
    assert mgr.summary()["launches_per_round"] == (1 if coalesce else 3)
    if coalesce:
        assert mgr._coalesced.traces == 1
        assert mgr.compile_counters()["round_traces"] == 1
    for i, (t, (v, pname)) in enumerate(zip(tids, MODEL_LANES)):
        ref = _session(psets[pname], g, tcfg if v == "teacher" else cfg,
                       coalesce=coalesce)
        rt = ref.add_tenant(name="solo")
        for r in range(4):
            o = ref.step({rt: feeds[t][r]})[rt]
            assert torch.equal(traj[t][r], o.emb_src), f"lane {i} r {r}"
        _assert_state_equal(mgr.state_of(t), ref.state_of(rt), f"lane {i}")
    # the weights are load-bearing
    base = _session(psets[None], g, cfg, coalesce=coalesce)
    bt = base.add_tenant()
    for r in range(4):
        ob = base.step({bt: feeds[tids[2]][r]})[bt]
    assert not torch.equal(traj[tids[2]][-1], ob.emb_src)


def test_param_store_lifecycle_and_errors(small_graph):
    g = small_graph
    cfg, tcfg, psets = _model_fleet_params(g)
    mgr = _session(psets[None], g, cfg)
    a = mgr.add_tenant()
    with pytest.raises(ValueError, match="unknown param set"):
        mgr.add_tenant(params="nope")
    assert mgr.tenants == (a,)
    mgr.register_params("s", psets["student-B"])
    mgr.register_params("s", psets["student-B"])
    assert mgr.param_store.names() == ("default", "s")
    with pytest.raises(ValueError, match="immutable"):
        mgr.register_params("s", psets["teacher-v1"])
    with pytest.raises(ValueError, match="non-empty string"):
        mgr.register_params("", psets["student-B"])
    with pytest.raises(ValueError, match="does not fit"):
        mgr.add_tenant("teacher", params="s")
    with pytest.raises(ValueError, match="shares sat\\+lut parameters"):
        mgr.add_tenant("teacher")
    assert mgr.param_store.digest("s") != mgr.param_store.digest("default")


def test_edge_counts_defer_to_summary(small_graph):
    g = small_graph
    dims = _dims(g)
    cfg = tpl.variant_config("sat+lut+np4", **dims)
    params = _params(cfg, 9)
    for coalesce in (True, False):
        mgr, tids = _mixed_fleet(g, params, cfg, 3, coalesce)
        feeds = {i: list(_tenant_stream(g, i, batch=20, rounds=3))
                 for i in range(3)}
        for r in range(3):
            mgr.step({tids[i]: feeds[i][r] for i in range(3)})
            assert isinstance(mgr.metrics[-1]["edges"], torch.Tensor)
        s = mgr.summary()
        assert sum(int(m["edges"]) for m in mgr.metrics[1:]) == 2 * 3 * 20
        assert s["rounds"] == 2 and s["launches_per_round"] == (
            1 if coalesce else 3)
        assert s["per_tenant"][tids[0]]["rounds"] == 3


def test_engine_is_a_one_tenant_view_and_peek_is_unchanged(small_graph):
    """The engine's device batches take the per-cohort path (no round trip
    through the host stager), one launch a round, and ``peek`` equals
    ``process`` without committing."""
    g = small_graph
    dims = _dims(g)
    cfg = tpl.variant_config("sat+lut+np4", **dims)
    eng = _engine("sat+lut+np4", _params(cfg, 10), g, dims)
    assert eng.session.coalesce and eng.session.tenants == (eng.tid,)
    batches = list(_tenant_stream(g, 0, rounds=2))
    peeked = eng.session.peek(eng.tid, batches[0])
    hs, _ = eng.process(batches[0])
    assert torch.equal(peeked.emb_src, hs)
    _assert_state_equal(peeked.state, eng.state, "peek state")
    assert eng.session.metrics[-1]["launches"] == 1
    assert eng.session._stager is None
    vids = torch.as_tensor(np.concatenate([batches[1].src, batches[1].dst]))
    t = torch.as_tensor(np.concatenate([batches[1].ts, batches[1].ts]))
    h = eng.embed(vids, t)[0]
    want = eng.pipeline.embed(eng.params, eng.aux, eng.state, eng.edge_feats,
                              None, vids, t)[0]
    assert torch.equal(h, want)


def test_reserve_mode_compile_counters_frozen_across_admission(small_graph):
    """Attach and detach into spare slots leave the layout counters alone;
    exhausting the capacity class relays out exactly once."""
    g = small_graph
    dims = _dims(g)
    cfg = tpl.variant_config("sat+lut+np4", **dims)
    mgr = _session(_params(cfg, 21), g, cfg, reserve=True)
    assert isinstance(mgr.reserve, CapacityLadder)
    tids = [mgr.add_tenant(name=f"t{i}") for i in range(3)]
    feeds = list(_tenant_stream(g, 0, batch=20, rounds=7))

    def step(r):
        mgr.step({t: feeds[r] for t in mgr.tenants})

    step(0)
    step(1)
    c0 = mgr.compile_counters()
    assert c0 == {"relayouts": 1, "round_traces": 1, "round_calls": 2}
    layout = mgr._coalesced
    extra = mgr.add_tenant(name="late")
    step(2)
    mgr.remove_tenant(extra)
    step(3)
    fresh = mgr.add_tenant(name="later")       # lands in the freed slot
    step(4)
    c1 = mgr.compile_counters()
    assert (c1["relayouts"], c1["round_traces"]) == (c0["relayouts"], 1)
    assert mgr._coalesced is layout and c1["round_calls"] == 5
    # the reused slot starts from a fresh state, not the departed one's
    solo = _session(mgr.params, g, cfg)
    st = solo.add_tenant()
    solo.step({st: feeds[4]})
    _assert_state_equal(mgr.state_of(fresh), solo.state_of(st), "reused slot")
    mgr.add_tenant(name="overflow")            # 5 > the class of 4
    assert mgr._coalesced is None
    step(5)
    step(6)
    c2 = mgr.compile_counters()
    assert c2["relayouts"] == c1["relayouts"] + 1
    assert c2["round_traces"] == 1 and c2["round_calls"] == 2
    assert len(tids) + 2 == len(mgr.tenants)


def test_prewarmed_lane_admits_without_a_relayout(small_graph):
    g = small_graph
    dims = _dims(g)
    cfg = tpl.variant_config("sat+lut+np4", **dims)
    mgr = _session(_params(cfg, 12), g, cfg, reserve=CapacityLadder())
    a = mgr.add_tenant()
    mgr.prewarm_cohort("sat+lut+np2")
    mgr.step({a: next(_tenant_stream(g, 0))})
    relayouts = mgr.compile_counters()["relayouts"]
    b = mgr.add_tenant("sat+lut+np2")
    assert mgr.last_admission == {"tid": b, "relayout": False,
                                  "new_cohort": False}
    mgr.step({a: next(_tenant_stream(g, 1)), b: next(_tenant_stream(g, 2))})
    assert mgr.compile_counters()["relayouts"] == relayouts
    with pytest.raises(ValueError, match="reserve policy"):
        _session(mgr.params, g, cfg).prewarm_cohort()


# ---------------------------------------------------------------------------
# guards of the stacked layout
# ---------------------------------------------------------------------------


def test_stacked_ids_and_grids_are_guarded(small_graph):
    """Ids into a cohort's tables are int32, so T·(V + 1) < 2**31; rows on
    grid.y fit 65,535 blocks. The wrappers' row tiles are common.cuh's."""
    src = (Path(ops.__file__).parent / "csrc" / "common.cuh").read_text()

    def const(name):
        (value,) = re.findall(rf"constexpr int {name} = (\d+);", src)
        return int(value)

    assert ops.GRU_ROWS == 16 * const("kGruMTiles")
    assert ops.OUT_ROWS == 16 * const("kOutMTiles")
    assert ops.EU_MTILES == const("kEuMTiles")
    assert ops.eu_rows_per_block(10) == 2 and ops.eu_rows_per_block(4) == 8
    ops._check_grid_rows("x", ops.MAX_GRID_Y * 16, 16)
    with pytest.raises(ValueError, match="grid.y"):
        ops._check_grid_rows("x", ops.MAX_GRID_Y * 16 + 1, 16)
    g = small_graph
    dims = dict(_dims(g), n_nodes=2 ** 31 - 1)
    cfg = tpl.variant_config("sat+lut+np4", **dims)
    mgr = _session(_params(cfg, 0), g, cfg)
    with pytest.raises(ValueError, match="int32"):
        mgr.add_tenant()


# ---------------------------------------------------------------------------
# against the JAX package's SessionManager
# ---------------------------------------------------------------------------

JAX_LANES = (("sat+lut+np4", None), ("sat+lut+np4+reservoir", None),
             ("teacher", "teacher-v1"))


@pytest.mark.parametrize("tier", ["ref", "staged", "fused"])
def test_fleet_matches_the_reference_session(small_graph, tier):
    """Three tenants on mixed lanes (np4, np4 + reservoir, the teacher on
    its own set), one round in four ragged, one tenant idle a round: the
    port's session and the reference's on the same batches and weights."""
    g = small_graph
    dims = _dims(g)
    jcfg = jpl.variant_config("sat+lut+np4", **dims)
    jtcfg = jpl.variant_config("teacher", **dims)
    jp = jax.tree.map(np.asarray,
                      jtgn.init_params(jax.random.key(30), jcfg))
    jtp = jax.tree.map(np.asarray,
                       jtgn.init_params(jax.random.key(31), jtcfg))
    jm = JSessionManager(jp, jnp.asarray(g.edge_feats), model=jcfg,
                         use_kernels=tier)
    jm.register_params("teacher-v1", jtp)
    tm = _session(convert.params_from_reference(jp, "cpu"), g,
                  tpl.variant_config("sat+lut+np4", **dims),
                  use_kernels=tier)
    tm.register_params("teacher-v1", convert.params_from_reference(jtp,
                                                                   "cpu"))
    jt = [jm.add_tenant(v, params=p) for v, p in JAX_LANES]
    tt = [tm.add_tenant(v, params=p) for v, p in JAX_LANES]
    assert tm.cohort_of(tt[0]).tier == jm.cohort_of(jt[0]).tier
    feeds = [list(_tenant_stream(g, i, batch=20, rounds=4)) for i in range(3)]
    for r in range(4):
        batches = {}
        for i in range(3):
            if r == 2 and i == 1:
                continue
            b = feeds[i][r]
            valid = b.valid & (np.arange(20) < 13) if r == 1 else b.valid
            batches[i] = (b.src, b.dst, b.eid, b.ts, valid)
        jo = jm.step({jt[i]: b for i, b in batches.items()})
        to = tm.step({tt[i]: b for i, b in batches.items()})
        tol = STEP_TOL if r == 0 else TRAJ_TOL
        for i in batches:
            for f in OUT_FIELDS:
                want = np.asarray(getattr(jo[jt[i]], f))
                got = getattr(to[tt[i]], f).numpy()
                if f == "nbr_valid":
                    np.testing.assert_array_equal(got, want)
                else:
                    np.testing.assert_allclose(got, want, err_msg=(
                        f"round {r} tenant {i} {f}"), **tol)
    for i in range(3):
        want, got = jm.state_of(jt[i]), tm.state_of(tt[i])
        for f in mailbox.VertexState._fields:
            w, x = np.asarray(getattr(want, f)), getattr(got, f).numpy()
            if x.dtype.kind == "f":
                np.testing.assert_allclose(x, w, err_msg=f"tenant {i} {f}",
                                           **TRAJ_TOL)
            else:
                np.testing.assert_array_equal(x, w, err_msg=f"tenant {i} {f}")
        assert got.mail_valid.any() and int(got.nbr_cursor.max()) > 10
    assert sum(ops.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# the serve CLI's fleet mode
# ---------------------------------------------------------------------------


def test_serve_cli_serves_a_mixed_fleet_on_cpu(capsys):
    serve.main(["--device", "cpu", "--edges", "400", "--batch", "50",
                "--f-mem", "8", "--kernels", "fused", "--tenant-variants",
                "sat+lut+np4,sat+lut+np4+reservoir,teacher",
                "--tenant-params", ",,teacher-v1"])
    out = capsys.readouterr().out
    assert "session cohorts:" in out and "session summary:" in out
    assert "registered param set 'teacher-v1'" in out
    assert "'launches_per_round': 1" in out
