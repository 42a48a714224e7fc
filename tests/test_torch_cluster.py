"""The port's sharded tenant fabric (``repro_torch.serving.cluster``) on a
mesh of eight repeats of the host's CPU.

Ported from the reference's ``tests/test_cluster.py``, which needs eight
JAX devices and skips in tier-1: trajectories through
``ShardedSessionManager`` equal the unsharded ``SessionManager``'s bit for
bit on every tier, mesh shape and round kind (coalesced and per-cohort,
idle and ragged rounds, mixed sampler, tier and model fleets); snapshots
restore across mesh shapes and continue bit for bit; migration, the
config-mismatch rejection, the eager capacity shrink, reserve admission
and a crash mid-write behave as the reference's. On the CPU every
kernel entry point runs its plain version.

Against the JAX package: a sharded fleet and the reference's unsharded
``SessionManager`` on the same seeded batches and weights, held to the
tolerances ``tests/test_torch_session.py`` states (the first round to
STEP_TOL, later rounds to TRAJ_TOL; integer tables equal).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as jpl
from repro.core import tgn as jtgn
from repro.serving.session import SessionManager as JSessionManager

from repro_torch import convert
from repro_torch.core import mailbox, tgn
from repro_torch.core import pipeline as pl
from repro_torch.data import stream
from repro_torch.data import temporal_graph as tgd
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import tgn_sharding as tsh
from repro_torch.serving import cluster as cl
from repro_torch.serving.guard import FleetGuard
from repro_torch.serving.session import SessionManager

torch.set_num_threads(1)

STEP_TOL = dict(rtol=1e-5, atol=1e-5)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)
CPUS = ["cpu"] * 8


@pytest.fixture(scope="module")
def small_graph():
    return tgd.wikipedia_like(n_edges=500)


def _dims(g, f=8):
    return dict(n_nodes=g.cfg.n_nodes, n_edges=g.n_edges, f_edge=172,
                f_mem=f, f_time=f, f_emb=f, m_r=10)


def _setup(g, variant="sat+lut+np4", seed=0, f=8):
    cfg = pl.variant_config(variant, **_dims(g, f))
    return cfg, tgn.init_params(torch.Generator().manual_seed(seed), cfg,
                                "cpu")


def _flat(params, g, cfg, **kw):
    return SessionManager(params, g.edge_feats, model=cfg, device="cpu",
                          **kw)


def _sharded(params, g, cfg, mesh, **kw):
    return cl.ShardedSessionManager(
        params, g.edge_feats, model=cfg,
        mesh=tsh.make_tenant_mesh(mesh, devices=CPUS), **kw)


def _feeds(g, tids, rounds=3, batch=30):
    return {t: list(stream.fixed_count(
        g, batch, window=slice(50 * i, 50 * i + batch * rounds), seed=i))
        for i, t in enumerate(tids)}


def _assert_state_equal(a, b, msg=""):
    for f in mailbox.VertexState._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f"{msg}: {f}"


def _assert_out_equal(a, b, msg=""):
    for f in ("emb_src", "emb_dst", "attn_logits", "nbr_valid", "nbr_dt"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f"{msg}: {f}"


# ---------------------------------------------------------------------------
# sharded == unsharded, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["ref", "staged", "fused"])
@pytest.mark.parametrize("mesh", ["tenant=8", "tenant=4,vertex=2",
                                  "tenant=2"])
def test_sharded_bitwise_matches_unsharded(small_graph, mesh, tier):
    """Five tenants (not a multiple of the tenant axis: pad slots idle)
    reproduce the unsharded session's embeddings and final states bit for
    bit; one lane a tenant shard."""
    g = small_graph
    cfg, params = _setup(g)
    ref = _flat(params, g, cfg, use_kernels=tier)
    sh = _sharded(params, g, cfg, mesh, use_kernels=tier)
    rt = [ref.add_tenant() for _ in range(5)]
    st = [sh.add_tenant() for _ in range(5)]
    n_t = sh.mesh.shape["tenant"]
    cohort = sh.cohort_of(st[0])
    assert cohort.capacity == tsh.tenant_capacity(5, sh.mesh)
    assert len(cohort.shards) == n_t
    split = "vertex" in sh.mesh.shape
    assert all(bool(s.parts) == split for s in cohort.shards)
    fr, fs = _feeds(g, rt), _feeds(g, st)
    for r in range(3):
        o1 = ref.step({t: fr[t][r] for t in rt})
        o2 = sh.step({t: fs[t][r] for t in st})
        for t1, t2 in zip(rt, st):
            _assert_out_equal(o1[t1], o2[t2], f"round {r} {t2}")
    assert len(sh._coalesced.parts) == n_t
    for t1, t2 in zip(rt, st):
        _assert_state_equal(ref.state_of(t1), sh.state_of(t2), t2)
    moved = sh.obs.snapshot(prefix="fabric.").get(
        "fabric.vertex_exchange_bytes", 0)
    V = cfg.n_nodes
    per_vertex = sum(t.numel() * t.element_size()
                     for t in ref.state_of(rt[0])) // V
    # every round gathers and writes back every slot's rows that the
    # group's other devices own; the first device's stay where they are
    others = sum(b - a for a, b in cohort.ranges[1:]) if split else 0
    assert moved == 3 * 2 * cohort.capacity * others * per_vertex


def test_sharded_idle_and_ragged_rounds(small_graph):
    g = small_graph
    cfg, params = _setup(g, seed=1)
    ref = _flat(params, g, cfg)
    sh = _sharded(params, g, cfg, "tenant=8")
    rt = [ref.add_tenant() for _ in range(3)]
    st = [sh.add_tenant() for _ in range(3)]
    small = next(iter(stream.fixed_count(g, 16, window=slice(0, 16))))
    big = next(iter(stream.fixed_count(g, 40, window=slice(80, 120),
                                       seed=7)))
    o1 = ref.step({rt[0]: small, rt[2]: big})   # rt[1] idles; ragged B
    o2 = sh.step({st[0]: small, st[2]: big})
    assert set(o2) == {st[0], st[2]}
    _assert_out_equal(o1[rt[0]], o2[st[0]], "small")
    _assert_out_equal(o1[rt[2]], o2[st[2]], "big")
    for t1, t2 in zip(rt, st):
        _assert_state_equal(ref.state_of(t1), sh.state_of(t2), t2)


def test_mixed_sampler_cohorts_on_mesh(small_graph):
    g = small_graph
    cfg, params = _setup(g, seed=2)
    variants = ("sat+lut+np4", "sat+lut+np4+uniform",
                "sat+lut+np4+reservoir")
    ref = _flat(params, g, cfg)
    sh = _sharded(params, g, cfg, "tenant=2")
    rt = [ref.add_tenant(v) for v in variants]
    st = [sh.add_tenant(v) for v in variants]
    fr, fs = _feeds(g, rt, rounds=2), _feeds(g, st, rounds=2)
    for r in range(2):
        ref.step({t: fr[t][r] for t in rt})
        sh.step({t: fs[t][r] for t in st})
    assert sh.metrics[-1]["launches"] == 1          # one round call
    assert len(sh._coalesced.parts) == 3 * 2        # a lane a shard
    for t1, t2 in zip(rt, st):
        _assert_state_equal(ref.state_of(t1), sh.state_of(t2), t2)


def test_mixed_kernel_tier_fleet_on_mesh(small_graph):
    g = small_graph
    cfg, params = _setup(g, seed=5)
    lanes = ((None, "fused"), (None, "staged"),
             ("sat+lut+np4+reservoir", "fused"), (None, "ref"))
    ref = _flat(params, g, cfg, use_kernels="staged")
    sh = _sharded(params, g, cfg, "tenant=2,vertex=2",
                  use_kernels="staged")
    rt = [ref.add_tenant(v, use_kernels=t) for v, t in lanes]
    st = [sh.add_tenant(v, use_kernels=t) for v, t in lanes]
    assert {c.tier for c in sh._cohorts.values()} == {"fused", "staged",
                                                      "ref"}
    fr, fs = _feeds(g, rt), _feeds(g, st)
    for r in range(3):
        o1 = ref.step({t: fr[t][r] for t in rt})
        o2 = sh.step({t: fs[t][r] for t in st})
        assert sh.metrics[-1]["launches"] == 1
        for t1, t2 in zip(rt, st):
            _assert_out_equal(o1[t1], o2[t2], f"round {r} {t2}")
    for t1, t2 in zip(rt, st):
        _assert_state_equal(ref.state_of(t1), sh.state_of(t2), t2)


# ---------------------------------------------------------------------------
# coalesced rounds on the mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["tenant=8", "tenant=4,vertex=2"])
def test_sharded_coalesced_matches_percohort_bitwise(small_graph, mesh):
    """A mixed 3-cohort fleet of 8 tenants: the coalesced round and the
    per-cohort baseline, both on the mesh, through ragged widths and idle
    tenants, one call a coalesced round."""
    g = small_graph
    cfg, params = _setup(g, seed=6)
    variants = ("sat+lut+np4", "sat+lut+np2", "sat+lut+np4+reservoir")
    m1 = _sharded(params, g, cfg, mesh)
    m2 = _sharded(params, g, cfg, mesh, coalesce=False)
    t1 = [m1.add_tenant(variants[i % 3]) for i in range(8)]
    t2 = [m2.add_tenant(variants[i % 3]) for i in range(8)]
    for r, w in enumerate((30, 18, 30)):
        bs = {}
        for i in range(8):
            if r == 1 and i % 4 == 1:
                continue
            lo = 40 * i + r * w
            bs[i] = next(iter(stream.fixed_count(
                g, w, window=slice(lo, lo + w), seed=i)))
        before = m1._coalesced.calls if m1._coalesced is not None else 0
        o1 = m1.step({t1[i]: b for i, b in bs.items()})
        o2 = m2.step({t2[i]: b for i, b in bs.items()})
        assert m1._coalesced.calls == before + 1
        assert m1.metrics[-1]["launches"] == 1
        assert m2.metrics[-1]["launches"] == 3
        for i in bs:
            _assert_out_equal(o1[t1[i]], o2[t2[i]], f"round {r} {i}")
    for a, b in zip(t1, t2):
        _assert_state_equal(m1.state_of(a), m2.state_of(b), a)
    assert m1._coalesced.rows % m1.mesh.shape["tenant"] == 0


def test_sharded_coalesced_matches_unsharded_session(small_graph):
    g = small_graph
    cfg, params = _setup(g, seed=7)
    variants = ("sat+lut+np4", "sat+lut+np4+uniform")
    flat = _flat(params, g, cfg)
    sh = _sharded(params, g, cfg, "tenant=4")
    ft = [flat.add_tenant(v) for v in variants for _ in range(2)]
    st = [sh.add_tenant(v) for v in variants for _ in range(2)]
    fr, fs = _feeds(g, ft), _feeds(g, st)
    for r in range(3):
        o1 = flat.step({t: fr[t][r] for t in ft})
        o2 = sh.step({t: fs[t][r] for t in st})
        for a, b in zip(ft, st):
            _assert_out_equal(o1[a], o2[b], f"round {r} {b}")
    assert flat.metrics[-1]["launches"] == sh.metrics[-1]["launches"] == 1
    for a, b in zip(ft, st):
        _assert_state_equal(flat.state_of(a), sh.state_of(b), b)


@pytest.mark.parametrize("coalesce", [True, False])
def test_mixed_model_fleet_on_mesh_matches_unsharded(small_graph, coalesce):
    """A teacher lane and two student weight sets on the mesh: every
    registered set is replicated on the mesh's devices."""
    g = small_graph
    cfg, params = _setup(g, seed=20)
    tcfg, tparams = _setup(g, "teacher", seed=21)
    _, sparams = _setup(g, seed=22)
    lanes = (("sat+lut+np4", None), ("teacher", "teacher-v1"),
             ("sat+lut+np4", "student-B"))

    def fleet(mgr):
        mgr.register_params("teacher-v1", tparams)
        mgr.register_params("student-B", sparams)
        return mgr, [mgr.add_tenant(v, params=p) for v, p in lanes]

    flat, ft = fleet(_flat(params, g, cfg, coalesce=coalesce))
    sh, st = fleet(_sharded(params, g, cfg, "tenant=2", coalesce=coalesce))
    assert sum(1 for v in sh.describe().values() if "tenants" in v) == 3
    assert sh.describe()["mesh"] == {"tenant": 2}
    fr, fs = _feeds(g, ft), _feeds(g, st)
    for r in range(3):
        o1 = flat.step({t: fr[t][r] for t in ft})
        o2 = sh.step({t: fs[t][r] for t in st})
        assert sh.metrics[-1]["launches"] == (1 if coalesce else 3)
        for a, b in zip(ft, st):
            _assert_out_equal(o1[a], o2[b], f"round {r} {b}")
    if coalesce:
        assert sh._coalesced.traces == 1
        assert sh.summary()["launches_per_round"] == 1
    for a, b in zip(ft, st):
        _assert_state_equal(flat.state_of(a), sh.state_of(b), b)


def test_peek_on_the_mesh_equals_unsharded_and_commits_nothing(small_graph):
    g = small_graph
    cfg, params = _setup(g, seed=8)
    flat = _flat(params, g, cfg)
    sh = _sharded(params, g, cfg, "tenant=2,vertex=2")
    ft = [flat.add_tenant() for _ in range(3)]
    st = [sh.add_tenant() for _ in range(3)]
    fr, fs = _feeds(g, ft), _feeds(g, st)
    flat.step({t: fr[t][0] for t in ft})
    sh.step({t: fs[t][0] for t in st})
    before = sh.state_of(st[2])
    p1, p2 = flat.peek(ft[2], fr[ft[2]][1]), sh.peek(st[2], fs[st[2]][1])
    _assert_out_equal(p1, p2, "peek")
    _assert_state_equal(p1.state, p2.state, "peek state")
    _assert_state_equal(before, sh.state_of(st[2]), "uncommitted")


def test_guard_flags_a_poisoned_tenant_on_a_vertex_split_mesh(small_graph):
    g = small_graph
    cfg, params = _setup(g, seed=9)
    sh = _sharded(params, g, cfg, "tenant=2,vertex=2")
    guard = FleetGuard(sh)
    tids = [sh.add_tenant() for _ in range(3)]
    feeds = _feeds(g, tids, rounds=2)
    sh.guarded_step({t: feeds[t][0] for t in tids})
    st = sh.state_of(tids[1])
    V = cfg.n_nodes
    sh.set_state(tids[1], st._replace(
        memory=st.memory.index_fill(0, torch.tensor([V - 1]), float("nan"))))
    assert sh.cohort_of(tids[0]).finite_slots().tolist() == [True, False,
                                                              True, True]
    sh.guarded_step({t: feeds[t][1] for t in tids})
    assert sh.is_quarantined(tids[1]) and guard.quarantines == 1
    assert not sh.is_quarantined(tids[0])


# ---------------------------------------------------------------------------
# snapshots, restore and migration across mesh shapes
# ---------------------------------------------------------------------------


def test_snapshot_restores_across_mesh_shapes_and_continues(small_graph,
                                                            tmp_path):
    """Snapshot a tenant mid-stream on tenant=8, restore it onto
    tenant=2,vertex=2 and onto the unsharded session, and continue all
    three bit for bit."""
    g = small_graph
    cfg, params = _setup(g, seed=3)
    root = str(tmp_path)
    ref = _flat(params, g, cfg)
    sh = _sharded(params, g, cfg, "tenant=8")
    a_ref, a_sh = ref.add_tenant(), sh.add_tenant()
    feed = list(stream.fixed_count(g, 30, window=slice(0, 150)))
    for b in feed[:3]:
        ref.step({a_ref: b})
        sh.step({a_sh: b})
    cl.snapshot_tenant(sh, a_sh, root, step=3)
    assert cl.list_snapshots(root) == {a_sh: 3}
    assert cl.snapshot_meta(root, a_sh)["variant"] == "sat+lut+np4"

    sh2 = _sharded(params, g, cfg, "tenant=2,vertex=2")
    flat = _flat(params, g, cfg)
    b_sh = cl.restore_tenant(sh2, root, a_sh)
    b_flat = cl.restore_tenant(flat, root, a_sh, name="revived")
    assert b_flat == "revived"
    _assert_state_equal(sh.state_of(a_sh), sh2.state_of(b_sh), "restored")
    for b in feed[3:]:
        o_ref = ref.step({a_ref: b})[a_ref]
        _assert_out_equal(o_ref, sh2.step({b_sh: b})[b_sh], "sh2")
        _assert_out_equal(o_ref, flat.step({b_flat: b})[b_flat], "flat")
    _assert_state_equal(ref.state_of(a_ref), sh2.state_of(b_sh), "sh2")
    _assert_state_equal(ref.state_of(a_ref), flat.state_of(b_flat), "flat")
    # an in-place reload into the vertex-split lane
    assert cl.restore_tenant_state(sh2, root, b_sh) == 3
    _assert_state_equal(sh.state_of(a_sh), sh2.state_of(b_sh), "reloaded")


def test_migrate_tenant_between_meshes(small_graph, tmp_path):
    g = small_graph
    cfg, params = _setup(g, seed=4)
    src = _sharded(params, g, cfg, "tenant=8")
    dst = _sharded(params, g, cfg, "tenant=4")
    ref = _flat(params, g, cfg)
    a_src, a_ref = src.add_tenant(name="hot"), ref.add_tenant()
    feed = list(stream.fixed_count(g, 30, window=slice(0, 120)))
    for b in feed[:2]:
        src.step({a_src: b})
        ref.step({a_ref: b})
    moved = cl.migrate_tenant(src, a_src, dst, str(tmp_path), step=2)
    assert moved == "hot" and src.tenants == ()
    for b in feed[2:]:
        _assert_out_equal(ref.step({a_ref: b})[a_ref],
                          dst.step({moved: b})[moved], "moved")
    _assert_state_equal(ref.state_of(a_ref), dst.state_of(moved), "moved")
    back = cl.migrate_tenant(dst, moved, src, str(tmp_path))
    assert cl.list_snapshots(str(tmp_path)) == {"hot": 3}
    _assert_state_equal(ref.state_of(a_ref), src.state_of(back), "back")


def test_restore_config_mismatch_is_rejected(small_graph, tmp_path):
    g = small_graph
    cfg, params = _setup(g, f=8)
    mgr = _sharded(params, g, cfg, "tenant=2")
    tid = mgr.add_tenant()
    cl.snapshot_tenant(mgr, tid, str(tmp_path))
    cfg16, params16 = _setup(g, f=16)
    other = _sharded(params16, g, cfg16, "tenant=2")
    with pytest.raises(ValueError, match="config fields"):
        cl.restore_tenant(other, str(tmp_path), tid)
    assert other.tenants == ()


def test_sharded_capacity_shrinks_eagerly(small_graph):
    g = small_graph
    cfg, params = _setup(g, seed=5)
    mgr = _sharded(params, g, cfg, "tenant=2")
    tids = [mgr.add_tenant() for _ in range(3)]
    cohort = mgr.cohort_of(tids[0])
    assert cohort.capacity == 4              # 3 tenants pad to 2 x 2
    b = next(iter(stream.fixed_count(g, 30)))
    mgr.step({t: b for t in tids})
    keep = {t: mgr.state_of(t) for t in tids[1:]}
    mgr.remove_tenant(tids[0])
    assert cohort.capacity == 2 and len(cohort.shards) == 2
    for t in tids[1:]:
        _assert_state_equal(keep[t], mgr.state_of(t), t)
    assert set(mgr.step({t: b for t in tids[1:]})) == set(tids[1:])
    for t in tids[1:]:
        mgr.remove_tenant(t)
    assert cohort.shards == [] and cohort.capacity == 0


def test_sharded_reserve_live_admission(small_graph):
    g = small_graph
    cfg, params = _setup(g, seed=5)
    mgr = _sharded(params, g, cfg, "tenant=2", reserve=True)
    a = mgr.add_tenant()
    cohort = mgr.cohort_of(a)
    assert cohort.capacity == 2
    b = mgr.add_tenant()                     # a spare slot: no relayout
    assert not mgr.last_admission["relayout"] and cohort.capacity == 2
    feeds = _feeds(g, [a, b], rounds=2)
    for r in range(2):
        mgr.step({t: feeds[t][r] for t in (a, b)})
    mgr.remove_tenant(b)                     # swap-remove: the slot idles
    assert not mgr.last_admission["relayout"]
    assert cohort.capacity == 2 and cohort.size == 1
    ref = _sharded(params, g, cfg, "tenant=2")
    ra, rb = ref.add_tenant(), ref.add_tenant()
    for r in range(2):
        ref.step({ra: feeds[a][r], rb: feeds[b][r]})
    _assert_state_equal(mgr.state_of(a), ref.state_of(ra), "survivor")


def test_sharded_prewarmed_lane_keeps_its_tenants(small_graph):
    """A prewarmed lane on a vertex-split mesh is laid out once: laying
    its capacity out again with a tenant present changes nothing, and a
    slot is read through its pieces (``view`` raises: the slot's rows
    are not one view)."""
    g = small_graph
    cfg, params = _setup(g, seed=5)
    mgr = _sharded(params, g, cfg, "tenant=2,vertex=2", reserve=True)
    mgr.prewarm_cohort()
    a = mgr.add_tenant()
    assert not mgr.last_admission["relayout"]
    mgr.step({a: next(iter(stream.fixed_count(g, 30)))})
    cohort = mgr.cohort_of(a)
    before, shards = mgr.state_of(a), cohort.shards
    cohort.ensure_capacity()
    assert cohort.shards is shards
    _assert_state_equal(before, mgr.state_of(a), a)
    with pytest.raises(TypeError, match="read_slot"):
        cohort.view(0)


def test_snapshot_crash_mid_write_recovers(small_graph, tmp_path):
    g = small_graph
    cfg, params = _setup(g)
    mgr = _sharded(params, g, cfg, "tenant=2,vertex=2")
    tid = mgr.add_tenant()
    b = next(iter(stream.fixed_count(g, 30)))
    mgr.step({tid: b})
    cl.snapshot_tenant(mgr, tid, str(tmp_path), step=1)
    torn = os.path.join(str(tmp_path), tid, "step_00000002.tmp")
    os.makedirs(torn)
    with open(os.path.join(torn, "arr_00000.npy"), "wb") as f:
        f.write(b"\x93NUMPY garbage")
    assert cl.list_snapshots(str(tmp_path)) == {tid: 1}
    fresh = _flat(params, g, cfg)
    revived = cl.restore_tenant(fresh, str(tmp_path), tid, name="r")
    _assert_state_equal(mgr.state_of(tid), fresh.state_of(revived), "torn")
    mgr.step({tid: b})
    cl.snapshot_tenant(mgr, tid, str(tmp_path), step=2)   # gc's the tmp
    assert not os.path.exists(torn)
    assert ckpt.latest_step(os.path.join(str(tmp_path), tid)) == 2


def test_mesh_needs_its_devices(small_graph):
    """A mesh larger than the devices raises, and the mesh alone places
    the session: no fallback to fewer devices or another device."""
    g = small_graph
    cfg, params = _setup(g)
    with pytest.raises(RuntimeError, match="needs 16 devices, found 8"):
        _sharded(params, g, cfg, "tenant=8,vertex=2")
    with pytest.raises(TypeError, match="pass mesh=, not device="):
        cl.ShardedSessionManager(
            params, g.edge_feats, model=cfg, device="cpu",
            mesh=tsh.make_tenant_mesh(2, devices=CPUS))


# ---------------------------------------------------------------------------
# against the reference's unsharded session
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["ref", "fused"])
def test_sharded_fleet_matches_the_reference_session(small_graph, tier):
    """Three tenants (np4, np4 + reservoir, the teacher on its own set) on
    tenant=2,vertex=2, one tenant idle a round: the port's sharded session
    and the reference's unsharded one on the same batches and weights."""
    g = small_graph
    dims = _dims(g)
    jcfg = jpl.variant_config("sat+lut+np4", **dims)
    jtcfg = jpl.variant_config("teacher", **dims)
    jp = jax.tree.map(np.asarray, jtgn.init_params(jax.random.key(40), jcfg))
    jtp = jax.tree.map(np.asarray,
                       jtgn.init_params(jax.random.key(41), jtcfg))
    lanes = (("sat+lut+np4", None), ("sat+lut+np4+reservoir", None),
             ("teacher", "teacher-v1"))
    jm = JSessionManager(jp, jnp.asarray(g.edge_feats), model=jcfg,
                         use_kernels=tier)
    jm.register_params("teacher-v1", jtp)
    tm = _sharded(convert.params_from_reference(jp, "cpu"), g,
                  pl.variant_config("sat+lut+np4", **dims),
                  "tenant=2,vertex=2", use_kernels=tier)
    tm.register_params("teacher-v1",
                       convert.params_from_reference(jtp, "cpu"))
    jt = [jm.add_tenant(v, params=p) for v, p in lanes]
    tt = [tm.add_tenant(v, params=p) for v, p in lanes]
    feeds = [list(stream.fixed_count(g, 20, window=slice(60 * i,
                                                         60 * i + 60),
                                     seed=i)) for i in range(3)]
    for r in range(3):
        batches = {i: (b.src, b.dst, b.eid, b.ts, b.valid)
                   for i, b in ((i, feeds[i][r]) for i in range(3))
                   if (r, i) != (1, 1)}
        jo = jm.step({jt[i]: b for i, b in batches.items()})
        to = tm.step({tt[i]: b for i, b in batches.items()})
        tol = STEP_TOL if r == 0 else TRAJ_TOL
        for i in batches:
            for f in ("emb_src", "emb_dst", "attn_logits", "nbr_dt"):
                np.testing.assert_allclose(
                    getattr(to[tt[i]], f).numpy(),
                    np.asarray(getattr(jo[jt[i]], f)),
                    err_msg=f"round {r} tenant {i} {f}", **tol)
            np.testing.assert_array_equal(to[tt[i]].nbr_valid.numpy(),
                                          np.asarray(jo[jt[i]].nbr_valid))
    for i in range(3):
        want, got = jm.state_of(jt[i]), tm.state_of(tt[i])
        for f in mailbox.VertexState._fields:
            w, x = np.asarray(getattr(want, f)), getattr(got, f).numpy()
            if x.dtype.kind == "f":
                np.testing.assert_allclose(x, w, err_msg=f"{i} {f}",
                                           **TRAJ_TOL)
            else:
                np.testing.assert_array_equal(x, w, err_msg=f"{i} {f}")


# ---------------------------------------------------------------------------
# the serve CLI's --mesh
# ---------------------------------------------------------------------------


def test_serve_cli_serves_on_a_mesh_and_restores_onto_another(tmp_path,
                                                              capsys):
    from repro_torch.launch import serve
    common = ["--device", "cpu", "--edges", "600", "--batch", "50",
              "--f-mem", "8", "--kernels", "fused", "--tenants", "3",
              "--snapshot-dir", str(tmp_path)]
    serve.main(common + ["--mesh", "tenant=2,vertex=2"])
    out = capsys.readouterr().out
    assert "fabric mesh: {'tenant': 2, 'vertex': 2}" in out
    assert "'launches_per_round': 1" in out
    serve.main(common + ["--mesh", "4", "--restore"])
    out = capsys.readouterr().out
    assert "fabric mesh: {'tenant': 4}" in out
    assert "snapshots: {'t0': 4, 't1': 4, 't2': 4}" in out
    with pytest.raises(SystemExit):
        serve.main(common + ["--mesh", "2", "--listen", "127.0.0.1:0"])
