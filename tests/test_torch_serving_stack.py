"""The port's online serving stack against the reference's.

The same seeded inputs go through the JAX package's modules and the
port's:

- ``RoundTracer`` and ``SLOTracker`` (the cases of ``tests/test_obs.py``):
  equal results, exactly;
- ``DeadlineBatcher`` on a seeded event stream and a fake clock: the same
  flushes (rows, widths, arrival times), depths and ``RetryAfter``
  rejections;
- ``ServingFrontend.handle`` over a session on the ref, staged and fused
  tiers (the reference's kernel tiers in interpret mode, as its own tests
  run them): the same responses to every request (acks, ``RetryAfter``,
  dedup acks, errors, admissions), the same flushed batches, and the
  flushed rounds' embeddings and the final states within tolerance:
  STEP_TOL (rtol = atol = 1e-5) for the first round, from equal states,
  TRAJ_TOL (1e-4) after it, as in ``tests/test_torch_session.py``;
  integer and bool tables equal;
- journal segments written by either package read by the other, record
  for record, with the same cursors;
- tenant snapshots written by either package restored by the other, the
  state equal.

The serve CLI's serving-stack flags and the three smoke modules run on
the CPU too.
"""
import json
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro.core import pipeline as jpl
from repro.core import tgn as jtgn
from repro.serving import cluster as jcluster
from repro.serving import frontend as jfrontend
from repro.serving import journal as jjournal
from repro.serving.faults import FakeClock as JFakeClock
from repro.serving.session import SessionManager as JSessionManager

import repro_torch.obs as tobs
from repro_torch import convert
from repro_torch.core import mailbox
from repro_torch.core import pipeline as tpl
from repro_torch.data import stream
from repro_torch.data import temporal_graph as tgd
from repro_torch.distributed import checkpoint as tckpt
from repro_torch.kernels import ops
from repro_torch.launch import chaos_smoke, journal_smoke, serve, serve_smoke
from repro_torch.serving import cluster as tcluster
from repro_torch.serving import frontend as tfrontend
from repro_torch.serving import journal as tjournal
from repro_torch.serving.faults import FakeClock
from repro_torch.serving.session import SessionManager

torch.set_num_threads(1)

STEP_TOL = dict(rtol=1e-5, atol=1e-5)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def small_graph():
    return tgd.wikipedia_like(n_edges=500)


def _dims(g, f=8):
    return dict(n_nodes=g.cfg.n_nodes, n_edges=g.n_edges, f_edge=172,
                f_mem=f, f_time=f, f_emb=f, m_r=10)


def _jparams(g, seed=40):
    cfg = jpl.variant_config("sat+lut+np4", **_dims(g))
    return cfg, jax.tree.map(np.asarray,
                             jtgn.init_params(jax.random.key(seed), cfg))


def _port(g, tier, jp, **kw):
    return SessionManager(convert.params_from_reference(jp, "cpu"),
                          g.edge_feats,
                          model=tpl.variant_config("sat+lut+np4", **_dims(g)),
                          use_kernels=tier, device="cpu", **kw)


def _pair(g, tier, **kw):
    """The reference's session and the port's on the same weights."""
    jcfg, jp = _jparams(g)
    jm = JSessionManager(jp, jnp.asarray(g.edge_feats), model=jcfg,
                         use_kernels=tier, **kw)
    return jm, _port(g, tier, jp, **kw)


def _batches(g):
    return stream.fixed_count(g, 20, window=slice(0, 60), seed=3)


def _assert_states_close(want, got, tol, msg=""):
    for f in mailbox.VertexState._fields:
        w, x = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        if x.dtype.kind == "f":
            np.testing.assert_allclose(x, w, err_msg=f"{msg} {f}", **tol)
        else:
            np.testing.assert_array_equal(x, w, err_msg=f"{msg} {f}")


# ---------------------------------------------------------------------------
# tracer and SLO: the cases of tests/test_obs.py, on both packages
# ---------------------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _cadence(obs):
    tr = obs.RoundTracer(sample_every=4)
    hits = [tr.sample_round() for _ in range(9)]
    return hits, tr.rounds_seen, tr.rounds_sampled


def _would_sample(obs):
    tr = obs.RoundTracer(sample_every=2)
    out = [tr.would_sample(), tr.would_sample(), tr.rounds_seen]
    return out + [tr.sample_round(), tr.would_sample()]


def _spans_and_bound(obs):
    clk = _Clock()
    tr = obs.RoundTracer(clock=clk, max_spans=2)
    with tr.span("stage", cat="host", rows=3):
        clk.t += 0.5
    tr.add("launch", 100.5, 100.6, cat="host")
    tr.add("overflow", 0, 1)
    return [s.as_dict() for s in tr.spans], tr.dropped, tr.summary()


def _chrome_export(obs, tmp_path):
    tr = obs.RoundTracer(clock=_Clock())
    tr.add("ingest", 1.0, 1.01, cat="frontend", events=4)
    tr.add("stage", 1.01, 1.02, cat="host")
    tr.add("drain", 1.02, 1.05, cat="device")
    tr.add("quarantine", 1.05, 1.06, cat="guard", tenant="t1")
    path, jl = tmp_path / "trace.json", tmp_path / "trace.jsonl"
    tr.write_chrome(str(path))
    tr.write_jsonl(str(jl))
    return (tr.to_chrome(), json.loads(path.read_text()),
            [json.loads(ln) for ln in jl.read_text().splitlines()])


def _span_as_dict(obs):
    s = obs.Span("launch", "host", 2.0, 2.5, {"lanes": 2})
    return s.dur, s.as_dict()


def _slo_burn(obs):
    slo = obs.SLOTracker(target_ms=10.0, objective=0.9)
    for _ in range(8):
        slo.observe("t0", 0.005)
    slo.observe("t0", 0.020, n=2)
    slo.violation("t1", n=3)
    slo.observe("t1", 0.001)
    return slo.tenant("t0"), slo.tenant("t1"), slo.snapshot()


def _slo_zero(obs):
    slo = obs.SLOTracker(target_ms=25.0, objective=0.99, source="event")
    return slo.tenant("never-seen"), slo.snapshot()


def _slo_validation(obs):
    errors = []
    for kw in (dict(target_ms=0.0), dict(target_ms=5.0, objective=1.0),
               dict(target_ms=5.0, objective=0.0)):
        try:
            obs.SLOTracker(**kw)
        except ValueError as e:
            errors.append(str(e))
    return errors


@pytest.mark.parametrize("case", [_cadence, _would_sample, _spans_and_bound,
                                  _chrome_export, _span_as_dict, _slo_burn,
                                  _slo_zero, _slo_validation],
                         ids=lambda f: f.__name__.strip("_"))
def test_tracer_and_slo_match_the_reference(case, tmp_path):
    if case is _chrome_export:
        (tmp_path / "j").mkdir()
        (tmp_path / "t").mkdir()
        want = case(jobs, tmp_path / "j")
        got = case(tobs, tmp_path / "t")
    else:
        want, got = case(jobs), case(tobs)
    assert got == want


# ---------------------------------------------------------------------------
# the deadline batcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pad_quantum", [0, 4])
def test_batcher_matches_the_reference(small_graph, pad_quantum):
    """A seeded stream of submits, clock steps and flushes: the same
    rejections, depths, due flags and flushed batches."""
    g = small_graph
    rng = np.random.RandomState(pad_quantum)
    jc, tc = JFakeClock(), FakeClock()
    jb = jfrontend.DeadlineBatcher(jfrontend.FrontendConfig(
        max_wait_s=0.005, max_rows=3, queue_rows=7,
        pad_quantum=pad_quantum), jc)
    tb = tfrontend.DeadlineBatcher(tfrontend.FrontendConfig(
        max_wait_s=0.005, max_rows=3, queue_rows=7,
        pad_quantum=pad_quantum), tc)
    for b in (jb, tb):
        for tid in ("a", "b"):
            b.add_tenant(tid)
    i, n_flush = 0, 0
    for _ in range(80):
        op = rng.randint(5)
        if op < 3:
            tid = "aab"[op]
            ev = (int(g.src[i]), int(g.dst[i]), i, float(g.ts[i]),
                  int(g.dst[(i + 1) % g.n_edges]))
            i += 1
            outs = []
            for b in (jb, tb):
                try:
                    outs.append(("ok", b.submit(tid, *ev)))
                except (jfrontend.RetryAfter, tfrontend.RetryAfter) as e:
                    outs.append(("retry", e.tid, e.seconds, e.depth,
                                 e.reason))
            assert outs[0] == outs[1]
        elif op == 3:
            dt = float(rng.choice([0.001, 0.003, 0.006]))
            jc.advance(dt)
            tc.advance(dt)
        assert jb.due() == tb.due()
        assert jb.depths() == tb.depths()
        assert jb.next_deadline() == tb.next_deadline()
        if op == 4:
            (jbat, jarr), (tbat, tarr) = jb.take(), tb.take()
            assert jarr == tarr and sorted(jbat) == sorted(tbat)
            for tid in jbat:
                for f in jbat[tid]._fields:
                    np.testing.assert_array_equal(
                        getattr(tbat[tid], f), getattr(jbat[tid], f))
                    assert (getattr(tbat[tid], f).dtype
                            == getattr(jbat[tid], f).dtype)
                if pad_quantum:
                    assert tbat[tid].src.shape[0] % pad_quantum == 0
            n_flush += bool(jbat)
    assert (jb.accepted, jb.rejected, jb.flushes) == (
        tb.accepted, tb.rejected, tb.flushes)
    assert n_flush > 5 and tb.rejected > 0


# ---------------------------------------------------------------------------
# the front end's wire protocol, over both sessions
# ---------------------------------------------------------------------------


def _requests(g, rng):
    """A seeded request stream in rounds: per round, ingests for the
    resident tenants (client stamps; some resent, which must dedup),
    the odd malformed or unknown-tenant request; a tenant attached in
    round 2 and detached in round 4. ``None`` ends a round."""
    sent = {"a": 0, "b": 0, "c": 0}
    base = {"a": 0, "b": 150, "c": 300}
    live = ["a", "b"]
    out = []
    for r in range(6):
        if r == 2:
            out.append({"op": "attach", "name": "c"})
            live.append("c")
        if r == 4:
            out.append({"op": "detach", "tid": "c"})
            live.remove("c")
        for tid in live:
            # round 3 overfills a's queue: RetryAfter (queue_full)
            for _ in range(12 if (r, tid) == (3, "a") else rng.randint(2, 9)):
                i = base[tid] + sent[tid]
                req = {"op": "ingest", "tid": tid, "src": int(g.src[i]),
                       "dst": int(g.dst[i]), "eid": i, "ts": float(g.ts[i]),
                       "neg_dst": int(g.dst[(i + 3) % g.n_edges]),
                       "client_id": f"c-{tid}", "seq": sent[tid]}
                out.append(req)
                if rng.rand() < 0.25:
                    out.append(dict(req))            # a retry: dedups
                sent[tid] += 1
        if r == 1:
            out += [{"op": "ingest", "tid": "a", "src": 1},
                    {"op": "ingest", "tid": "zz", "src": 1, "dst": 2,
                     "ts": 1.0},
                    {"op": "ingest", "tid": "a", "src": 1, "dst": 2,
                     "ts": math.inf},
                    {"op": "bogus"}, ["not", "a", "dict"]]
        out.append(None)
    return out


@pytest.mark.parametrize("tier", ["ref", "staged", "fused"])
def test_frontend_matches_the_reference(small_graph, tier, tmp_path):
    g = small_graph
    jm, tm = _pair(g, tier, reserve=True)
    for m in (jm, tm):
        m.add_tenant(name="a")
        m.add_tenant(name="b")
    jc, tc = JFakeClock(), FakeClock()
    cfg = dict(max_wait_s=0.005, max_rows=6, queue_rows=8, pad_quantum=4)
    jfe = jfrontend.ServingFrontend(
        jm, jfrontend.FrontendConfig(**cfg), clock=jc, record_rounds=True,
        journal=jjournal.EventJournal(str(tmp_path / "jwal"), clock=jc))
    tfe = tfrontend.ServingFrontend(
        tm, tfrontend.FrontendConfig(**cfg), clock=tc, record_rounds=True,
        journal=tjournal.EventJournal(str(tmp_path / "twal"), clock=tc))
    rounds, replies = 0, 0
    for req in _requests(g, np.random.RandomState(7)):
        if req is None:
            jc.advance(0.006)
            tc.advance(0.006)
            jo, to = jfe.pump(), tfe.pump()
            assert sorted(jo) == sorted(to)
            tol = STEP_TOL if rounds == 0 else TRAJ_TOL
            for tid in jo:
                for f in ("emb_src", "emb_dst"):
                    np.testing.assert_allclose(
                        getattr(to[tid], f).numpy(),
                        np.asarray(getattr(jo[tid], f)),
                        err_msg=f"round {rounds} {tid} {f}", **tol)
            rounds += bool(jo)
            continue
        want, got = jfe.handle(req), tfe.handle(req)
        assert got == want, req
        replies += 1
    assert rounds == 6 and replies > 40
    assert len(jfe.round_log) == len(tfe.round_log)
    for jr, tr in zip(jfe.round_log, tfe.round_log):
        assert sorted(jr) == sorted(tr)
        for tid in jr:
            for f in jr[tid]._fields:
                np.testing.assert_array_equal(getattr(tr[tid], f),
                                              getattr(jr[tid], f))
    js, ts = jfe.stats(), tfe.stats()
    for k in ("tenants", "rounds", "events", "accepted", "rejected",
              "flushes", "queue_depths"):
        assert ts[k] == js[k], k
    assert ts["journal"] == js["journal"] and tfe.dedups > 0
    assert ts["rejected"] > 0              # the queue bound was hit
    for tid in ("a", "b"):
        _assert_states_close(jm.state_of(tid), tm.state_of(tid), TRAJ_TOL,
                             tid)
    assert sum(ops.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# journal segments and snapshots, across packages
# ---------------------------------------------------------------------------


def _journal_session(mod, root, g):
    j = mod.EventJournal(str(root), segment_bytes=600)
    for i in range(12):
        j.append_event("t0", int(g.src[i]), int(g.dst[i]), i, float(g.ts[i]),
                       int(g.dst[i + 1]), client_id="c", seq=i)
        if i % 5 == 4:
            j.note_flush("t0", 5, 8)
    cursor = j.cursor("t0")
    j.close()
    return cursor


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_journal_segments_cross_read(small_graph, writer, tmp_path):
    """Segments written by one package: the other's ``records``, reopened
    counters and dedup windows, and replay see the same log."""
    g = small_graph
    wmod, rmod = ((tjournal, jjournal) if writer == "port"
                  else (jjournal, tjournal))
    cursor = _journal_session(wmod, tmp_path / "wal", g)
    reread = {}
    for name, mod in (("writer", wmod), ("reader", rmod)):
        j = mod.EventJournal(str(tmp_path / "wal"))
        recs = list(j.records("t0"))
        log = j.log_for("t0")
        steps = []
        res = j.replay("t0", {"segment": 0, "offset": 0, "events": 0},
                       steps.append)
        reread[name] = (recs, j.cursor("t0"), log.appended, log.flushed,
                        len(log.segments()), j.is_duplicate("t0", "c", 11),
                        j.is_duplicate("t0", "c", 12), res.rounds,
                        res.events, res.pending,
                        [{t: tuple(np.asarray(x).tolist() for x in b)
                          for t, b in s.items()} for s in steps])
        j.close()
    assert reread["reader"] == reread["writer"]
    recs = reread["reader"][0]
    assert len(recs) == 14 and reread["reader"][4] > 1      # rotated
    assert reread["reader"][1] == cursor


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_snapshots_cross_restore(small_graph, writer, tmp_path):
    """A snapshot of a served tenant written by one package restores in
    the other (``restore_tenant``, ``restore_tenant_state``), state equal,
    config and params digest checked."""
    g = small_graph
    jm, tm = _pair(g, "staged")
    src_m, dst_m = (tm, jm) if writer == "port" else (jm, tm)
    tid = src_m.add_tenant(name="t0")
    src_m.add_tenant(name="t1")
    for b in _batches(g):
        src_m.step({tid: b[:5]})
    src_m.sync()
    root = str(tmp_path / "snaps")
    mod_w = tcluster if writer == "port" else jcluster
    mod_r = jcluster if writer == "port" else tcluster
    mod_w.snapshot_tenant(src_m, tid, root, step=3,
                          extra_meta={"journal": {"segment": 0}})
    meta = mod_r.snapshot_meta(root, tid)
    assert meta["use_kernels"] == "staged" and meta["journal"] == {
        "segment": 0}
    assert mod_r.list_snapshots(root) == {tid: 3}
    new = mod_r.restore_tenant(dst_m, root, tid, name="r0")
    want = src_m.state_of(tid)
    got = dst_m.state_of(new)
    for f in mailbox.VertexState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)
    dst_m.add_tenant(name="t0")
    assert mod_r.restore_tenant_state(dst_m, root, "t0") == 3
    for f in mailbox.VertexState._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(dst_m.state_of("t0"), f)),
            np.asarray(getattr(want, f)), f)


def test_snapshot_capture_and_migrate_on_the_port(small_graph, tmp_path):
    """The background writer's capture is a copy: a round committed after
    ``submit`` does not reach the snapshot; ``migrate_tenant`` moves a
    tenant between sessions; a config mismatch is refused."""
    g = small_graph
    _cfg, jp = _jparams(g)
    a, b = _port(g, "fused", jp), _port(g, "fused", jp)
    t = a.add_tenant(name="t0")
    batches = list(_batches(g))
    a.step({t: batches[0]})
    before = a.state_of(t)
    w = tcluster.TenantSnapshotWriter(str(tmp_path / "w"))
    assert w.submit(a, t, step=1)
    a.step({t: batches[1]})
    w.close()
    snap, _meta = tckpt.restore(str(tmp_path / "w" / t), before._asdict(),
                                device="cpu")
    for f in mailbox.VertexState._fields:
        assert torch.equal(snap[f], getattr(before, f)), f
    after = a.state_of(t)
    new = tcluster.migrate_tenant(a, t, b, str(tmp_path / "m"))
    assert t not in a.tenants and new in b.tenants
    assert all(torch.equal(x, y) for x, y in zip(b.state_of(new), after))
    other = SessionManager(b.params, g.edge_feats,
                           model=b.base_cfg.replace(m_r=6), device="cpu")
    with pytest.raises(ValueError):
        tcluster.restore_tenant(other, str(tmp_path / "m"), t)


def test_journal_refuses_device_columns(small_graph, tmp_path):
    """``append_batch`` reads host columns only: a tensor on a device
    would be read back with a wait every round."""
    j = tjournal.EventJournal(str(tmp_path / "wal"))
    b = next(iter(_batches(small_graph)))
    j.append_batch("t0", b._replace(src=torch.as_tensor(b.src)))
    with pytest.raises(TypeError, match="host columns"):
        j.append_batch("t0", b._replace(
            src=torch.empty(b.src.shape, dtype=torch.int32, device="meta")))
    assert j.log_for("t0").flushed == int(b.valid.sum())
    j.close()


# ---------------------------------------------------------------------------
# the CLI and the smokes, on the CPU
# ---------------------------------------------------------------------------


def test_serve_cli_stack_flags_on_cpu(tmp_path, capsys):
    args = ["--device", "cpu", "--tenants", "2", "--edges", "400",
            "--batch", "50", "--f-mem", "8", "--kernels", "fused",
            "--guard", "--journal-dir", str(tmp_path / "wal"),
            "--snapshot-dir", str(tmp_path / "snaps"), "--snapshot-every",
            "2", "--slo-ms", "25", "--trace-out",
            str(tmp_path / "trace.jsonl"), "--trace-every", "2",
            "--metrics-every", "2"]
    summary = serve.main(args)
    out = capsys.readouterr().out
    assert summary["launches_per_round"] == 1
    assert all("slo" in st and "guard" in st
               for st in summary["per_tenant"].values())
    assert "guard: {'quarantines': 0" in out and "journal:" in out
    assert "metrics (round 2):" in out
    spans = [json.loads(ln) for ln in
             (tmp_path / "trace.jsonl").read_text().splitlines()]
    assert {"stage", "launch", "h2d", "drain"} <= {s["name"] for s in spans}
    assert tcluster.list_snapshots(str(tmp_path / "snaps")) == {"t0": 4,
                                                                "t1": 4}
    serve.main(args[:-6] + ["--restore"])
    out = capsys.readouterr().out
    assert "restored tenant 't0'" in out and "restored tenant 't1'" in out
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--restore"])


@pytest.mark.parametrize("smoke", [serve_smoke, chaos_smoke, journal_smoke],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_smokes_pass_on_cpu(smoke, capsys):
    assert smoke.main(["--device", "cpu"]) == 0
    assert "FAIL" not in capsys.readouterr().out


def test_chaos_leg_passes_with_a_slow_snapshot_disk(monkeypatch, capsys):
    """Each snapshot write takes a second, so the writer skips the sick
    tenant's round-2 submission (its round-0 write, retried after the
    injected IO fault, is still in flight) and the guard restores the
    round-0 snapshot: the leg replays from the snapshot that was written,
    not from the round it asked for."""
    save = tcluster.ckpt.save

    def slow_save(*args, **kwargs):
        time.sleep(1.0)
        return save(*args, **kwargs)
    monkeypatch.setattr(tcluster.ckpt, "save", slow_save)
    assert chaos_smoke.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "FAIL" not in out and "restored from round" not in out


@pytest.mark.parametrize("n, k", [(5, 0), (6, 1), (24, 7), (60, 22)])
def test_guard_cost_interval_is_the_binomial_order_statistics(n, k):
    """``serve_smoke.median_ci`` gives order statistics k and n + 1 - k,
    k the largest with P(Binomial(n, 1/2) < k) <= 0.025 (none under 6
    pairs), whatever order the differences come in."""
    d = np.random.default_rng(n).permutation(np.arange(n, dtype=float))
    m, lo, hi = serve_smoke.median_ci(d)
    assert m == np.median(d)
    if k == 0:
        assert (lo, hi) == (-math.inf, math.inf)
    else:
        assert (lo, hi) == (k - 1, n - k)
    assert sum(math.comb(n, j) for j in range(k)) / 2 ** n <= 0.025
    assert sum(math.comb(n, j) for j in range(k + 1)) / 2 ** n > 0.025
