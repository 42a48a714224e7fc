"""The port's single-model surface beyond the step, against the JAX package:
the engine's summary keys, the GDELT-like graph and static node features,
``embed``, ``process_batch``, the link head and ``step_on_device``.

Sizes are small (a few hundred edges, model widths 8-16). Inputs come from
numpy seeds; weights and state cross over through ``repro_torch.convert``.
Where the reference reaches a Pallas kernel (its staged tier) the kernel
runs in interpret mode, as the reference's own tests run it on the CPU.

Tolerances, as in tests/test_torch_trajectory.py: integer and bool tables
must be equal; a step or an ``embed`` from the same input state agrees to
rtol = atol = 1e-5 (fp32 sums in other orders); over a 20-batch
trajectory each side feeds on its own state and the GRU carries the
rounding forward, so the trajectory is held to 1e-4. The summary keys and
the generated graphs must be equal.
"""
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as jpl
from repro.core import tgn as jtgn
from repro.data import stream as jstream
from repro.data import temporal_graph as jtgd
from repro.obs import metrics as jmetrics
from repro.serving import engine as jengine

from repro_torch import convert
from repro_torch.core import pipeline as tpl
from repro_torch.core import stages, tgn
from repro_torch.data import stream, temporal_graph as tgd
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.obs import metrics
from repro_torch.serving.engine import EngineConfig, StreamingEngine

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
#: the environment of a subprocess that runs the port on the CPU: one
#: OpenMP / MKL thread, as this process runs with ``set_num_threads(1)``
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
F = 16                  # f_mem = f_time = f_emb
B = 15                  # batch size
N_BATCHES = 20
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)
INT_FIELDS = ("mail_valid", "nbr_ids", "nbr_eid", "nbr_cursor")
FLOAT_FIELDS = ("memory", "last_update", "mail", "mail_ts", "nbr_ts")
SUMMARY_KEYS = {"batches", "mean_latency_ms", "p99_latency_ms",
                "mean_h2d_ms", "throughput_eps"}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(dataset="gdelt"):
    """A small graph of ``dataset``, the reference's config and weights,
    and N_BATCHES batches (batch 3 half padding)."""
    g = jtgd.DATASETS[dataset](n_edges=N_BATCHES * B)
    dims = dict(n_nodes=g.cfg.n_nodes, n_edges=g.n_edges,
                f_edge=g.cfg.f_edge, f_feat=g.cfg.f_feat, f_mem=F, f_time=F,
                f_emb=F, m_r=10)
    jcfg = jpl.variant_config("sat+lut+np4", **dims)
    params = jpl.build_pipeline(jcfg).init_params(jax.random.key(0))
    batches = []
    for i, b in enumerate(jstream.fixed_count(g, B)):
        valid = np.asarray(b.valid).copy()
        if i == 3:
            valid[B // 2:] = False
        batches.append((b.src, b.dst, b.eid, b.ts, valid))
    return g, jcfg, dims, params, batches


def _check_state(got, want, tol, where):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)),
                                      err_msg=f"{where}: {f}")
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(got[f], np.asarray(getattr(want, f)),
                                   err_msg=f"{where}: {f}", **tol)


def _nf(g):
    return None if g.node_feats is None else torch.as_tensor(g.node_feats)


# ---------------------------------------------------------------------------
# summary keys: the reference's histogram arithmetic
# ---------------------------------------------------------------------------


def _latencies(n, seed):
    """Per-batch records of non-constant, heavy-tailed latencies."""
    rng = np.random.RandomState(seed)
    lat = rng.lognormal(np.log(3e-3), 0.4, n)
    h2d = rng.lognormal(np.log(2e-4), 0.3, n)
    edges = rng.randint(50, 201, n)
    return [{"latency_s": float(a), "edges": int(e), "h2d_s": float(h),
             "throughput_eps": float(e / a)}
            for a, h, e in zip(lat, h2d, edges)]


def _engine(n_edges=60):
    g = tgd.wikipedia_like(n_edges=n_edges)
    dims = dict(n_nodes=g.cfg.n_nodes, n_edges=g.n_edges, f_mem=4, f_time=4,
                f_emb=4)
    params = tpl.build_pipeline("sat+lut+np4", device="cpu",
                                **dims).init_params()
    return g, StreamingEngine.from_variant("sat+lut+np4", params,
                                           g.edge_feats, device="cpu",
                                           **dims)


@pytest.mark.parametrize("n,seed", [(200, 0), (57, 1), (1000, 2)])
def test_summary_equals_the_reference_summary_key_for_key(n, seed):
    """The port's summary() and the reference's, over the same records:
    p99 is the histogram's bucket midpoint (clamped), not a sample."""
    _, eng = _engine()
    eng.metrics = _latencies(n, seed)
    got = eng.summary()
    want = jengine.StreamingEngine.summary(
        types.SimpleNamespace(metrics=eng.metrics))
    assert set(got) == SUMMARY_KEYS
    assert got == want
    lat = sorted(m["latency_s"] for m in eng.metrics[1:])
    rank_sample = lat[min(len(lat) - 1, int(0.99 * len(lat)))] * 1e3
    assert got["p99_latency_ms"] != rank_sample     # a bucket, not a sample


@pytest.mark.parametrize("records", [0, 1])
def test_summary_of_too_few_batches_is_defined(records):
    _, eng = _engine()
    eng.metrics = _latencies(records, 3)
    want = jengine.StreamingEngine.summary(
        types.SimpleNamespace(metrics=eng.metrics))
    assert eng.summary() == want
    if records:
        assert want["p99_latency_ms"] == 0.0 and want["batches"] == 0


@pytest.mark.parametrize("q", [0.0, 0.5, 0.9, 0.99, 1.0])
def test_histogram_copy_matches_the_reference(q):
    rng = np.random.RandomState(4)
    xs = np.concatenate([rng.lognormal(-6, 2, 500), [0.0, 1e-9, 2e5]])
    got, want = metrics.Histogram("x"), jmetrics.Histogram("x")
    for x in xs:
        got.record(x)
        want.record(x)
    assert got.quantile(q) == want.quantile(q)
    assert got.snapshot() == want.snapshot()
    reg = metrics.MetricsRegistry()
    reg.histogram("lat").merge(got)
    reg.counter("n").inc(3)
    assert reg.snapshot()["lat"] == want.snapshot()
    assert reg.snapshot("n") == {"n": 3}


# ---------------------------------------------------------------------------
# data: the GDELT-like graph and time windows, array-equal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [2, 9])
def test_gdelt_like_is_array_equal(seed):
    want = jtgd.gdelt_like(n_edges=400, seed=seed)
    got = tgd.DATASETS["gdelt"](n_edges=400, seed=seed)
    for f in ("src", "dst", "ts", "edge_feats", "node_feats"):
        a, b = getattr(got, f), getattr(want, f)
        np.testing.assert_array_equal(a, b, err_msg=f)
        assert a.dtype == b.dtype
    assert got.cfg.asdict() == want.cfg.asdict()
    assert got.edge_feats.shape == (400, 0)
    assert got.node_feats.shape == (1000, 200)


@pytest.mark.parametrize("dataset", ["reddit", "gdelt"])
def test_time_window_batches_are_array_equal(dataset):
    g = tgd.DATASETS[dataset](n_edges=500)
    jg = jtgd.DATASETS[dataset](n_edges=500)
    ours = list(stream.time_window(g, 900.0, 64, window=slice(5, 480)))
    theirs = list(jstream.time_window(jg, 900.0, 64, window=slice(5, 480)))
    assert len(ours) == len(theirs) > 2
    for a, b in zip(ours, theirs):
        for f in stream.EdgeBatch._fields:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


# ---------------------------------------------------------------------------
# static node features: trajectories against the reference
# ---------------------------------------------------------------------------


def _jax_step(jcfg, tier):
    if tier == "process_batch":
        def step(params, state, batch, ef, nf):
            return jtgn.process_batch(params, jcfg, state, nf, ef, *batch)
        return jax.jit(step)
    return jax.jit(jpl.build_pipeline(jcfg, use_kernels=tier).step_fn)


@pytest.mark.parametrize("tier,jax_tier", [
    ("process_batch", "process_batch"),
    ("staged", "staged"),
    ("fused", "staged"),
])
def test_gdelt_trajectory_matches_reference(tier, jax_tier):
    """20 batches of a GDELT-like graph (200 static node features, no edge
    features): the port's ``process_batch`` against the reference's, and
    the port's staged tier (also as the fused request, which runs it)
    against the reference's staged tier in interpret mode."""
    g, jcfg, dims, params, batches = _setup("gdelt")
    jstep = _jax_step(jcfg, jax_tier)
    ef, nf = jnp.asarray(g.edge_feats), jnp.asarray(g.node_feats)
    tparams = convert.params_from_reference(_np(params), "cpu")
    assert tparams["attn"]["feat"]["w_s"].shape == (200, F)
    tef, tnf = torch.as_tensor(g.edge_feats), _nf(g)
    cfg = tpl.variant_config("sat+lut+np4", **dims)
    if tier == "process_batch":
        def step(state, tb):
            return tgn.process_batch(tparams, cfg, state, tnf, tef, *tb)
    else:
        pipe = tpl.TGNPipeline(cfg, tier, device="cpu")
        assert pipe.tier == "staged"
        aux = pipe.prepare(tparams)

        def step(state, tb):
            return pipe.step(tparams, aux, state, tb, tef, tnf)
    jstate = jpl.build_pipeline(jcfg).init_state()
    tstate = tgn.init_state(cfg, "cpu")
    ops.reset_launch_counts()
    for i, batch in enumerate(batches):
        tb = tuple(torch.as_tensor(np.asarray(x)) for x in batch)
        jout = jstep(params, jstate, tuple(map(jnp.asarray, batch)), ef, nf)
        one = step(convert.state_from_reference(_np(jstate), "cpu"), tb)
        for name in ("emb_src", "emb_dst", "attn_logits", "nbr_dt"):
            np.testing.assert_allclose(
                getattr(one, name).numpy(), np.asarray(getattr(jout, name)),
                err_msg=f"step {i}: {name}", **STEP_TOL)
        np.testing.assert_array_equal(one.nbr_valid.numpy(),
                                      np.asarray(jout.nbr_valid))
        _check_state(convert.state_to_numpy(one.state), jout.state,
                     STEP_TOL, f"step {i}")
        tout = step(tstate, tb)
        for name in ("emb_src", "emb_dst"):
            np.testing.assert_allclose(
                getattr(tout, name).numpy(), np.asarray(getattr(jout, name)),
                err_msg=f"trajectory step {i}: {name}", **TRAJ_TOL)
        jstate, tstate = jout.state, tout.state
        _check_state(convert.state_to_numpy(tstate), jstate, TRAJ_TOL,
                     f"trajectory step {i}")
    final = convert.state_to_numpy(tstate)
    assert final["mail_valid"].any() and final["nbr_cursor"].max() > 10
    assert sum(ops.LAUNCHES.values()) == 0          # plain versions on CPU


def test_node_features_change_the_embeddings():
    """W_s is on the path: zeroing the node features moves h."""
    g, jcfg, dims, params, batches = _setup("gdelt")
    tparams = convert.params_from_reference(_np(params), "cpu")
    cfg = tpl.variant_config("sat+lut+np4", **dims)
    tb = tuple(torch.as_tensor(np.asarray(x)) for x in batches[0])
    state = tgn.init_state(cfg, "cpu")
    ef, nf = torch.as_tensor(g.edge_feats), _nf(g)
    a = tgn.process_batch(tparams, cfg, state, nf, ef, *tb)
    b = tgn.process_batch(tparams, cfg, state, torch.zeros_like(nf), ef, *tb)
    assert not torch.allclose(a.emb_src, b.emb_src)


# ---------------------------------------------------------------------------
# embed and the link head
# ---------------------------------------------------------------------------


def _mid_stream(dataset, n_steps=8):
    """The reference's state after ``n_steps`` batches, and query vertices
    and times: a batch's sources and random negative destinations."""
    g, jcfg, dims, params, batches = _setup(dataset)
    jstep = _jax_step(jcfg, "process_batch")
    ef = jnp.asarray(g.edge_feats)
    nf = None if g.node_feats is None else jnp.asarray(g.node_feats)
    jstate = jpl.build_pipeline(jcfg).init_state()
    for batch in batches[:n_steps]:
        jstate = jstep(params, jstate, tuple(map(jnp.asarray, batch)), ef,
                       nf).state
    rng = np.random.RandomState(5)
    src, ts = batches[n_steps][0], batches[n_steps][3]
    neg = rng.randint(g.cfg.n_users, g.cfg.n_nodes, B).astype(np.int32)
    vids = np.concatenate([src, neg]).astype(np.int32)
    t_q = np.concatenate([ts, ts]).astype(np.float32)
    return g, jcfg, dims, params, jstate, vids, t_q


@pytest.mark.parametrize("dataset,tier", [
    ("wikipedia", "ref"), ("wikipedia", "staged"), ("wikipedia", "fused"),
    ("gdelt", "ref"), ("gdelt", "staged"), ("gdelt", "fused")])
def test_embed_matches_reference(dataset, tier):
    g, jcfg, dims, params, jstate, vids, t_q = _mid_stream(dataset)
    ef = jnp.asarray(g.edge_feats)
    nf = None if g.node_feats is None else jnp.asarray(g.node_feats)
    jpipe = jpl.build_pipeline(jcfg, use_kernels=tier)
    want = jpipe.embed(params, jpipe.prepare(params), jstate, ef, nf,
                       jnp.asarray(vids), jnp.asarray(t_q))
    pipe = tpl.build_pipeline("sat+lut+np4", use_kernels=tier, device="cpu",
                              **dims)
    assert pipe.tier == jpipe.tier
    tparams = convert.params_from_reference(_np(params), "cpu")
    got = pipe.embed(tparams, pipe.prepare(tparams),
                     convert.state_from_reference(_np(jstate), "cpu"),
                     torch.as_tensor(g.edge_feats), _nf(g),
                     torch.as_tensor(vids), torch.as_tensor(t_q))
    for name, a, b in zip(("h", "logits", "valid", "dt"), got, want):
        if name == "valid":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       err_msg=name, **STEP_TOL)
    assert np.asarray(want[2]).any()     # the queries have neighbours


@pytest.mark.parametrize("dataset", ["wikipedia", "gdelt"])
def test_tgn_embed_matches_reference(dataset):
    g, jcfg, dims, params, jstate, vids, t_q = _mid_stream(dataset)
    nf = None if g.node_feats is None else jnp.asarray(g.node_feats)
    want = jtgn._embed(params, jcfg, jstate, nf, jnp.asarray(g.edge_feats),
                       jnp.asarray(vids), jnp.asarray(t_q))
    cfg = tpl.variant_config("sat+lut+np4", **dims)
    got = tgn._embed(convert.params_from_reference(_np(params), "cpu"), cfg,
                     convert.state_from_reference(_np(jstate), "cpu"),
                     _nf(g), torch.as_tensor(g.edge_feats),
                     torch.as_tensor(vids), torch.as_tensor(t_q))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **STEP_TOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_link_score_and_loss_match_reference():
    g, jcfg, dims, params, batches = _setup("wikipedia")
    jout = jtgn.process_batch(params, jcfg,
                              jpl.build_pipeline(jcfg).init_state(), None,
                              jnp.asarray(g.edge_feats),
                              *map(jnp.asarray, batches[0]))
    rng = np.random.RandomState(6)
    neg = rng.randn(B, F).astype(np.float32)
    jloss, (jpos, jneg) = jtgn.link_loss(params, jout, jnp.asarray(neg))
    tparams = convert.params_from_reference(_np(params), "cpu")
    out = tgn.BatchOut(*(torch.as_tensor(np.array(x)) if i else None
                         for i, x in enumerate(jout)))
    loss, (pos, tneg) = tgn.link_loss(tparams, out, torch.as_tensor(neg))
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), **STEP_TOL)
    np.testing.assert_allclose(tneg.numpy(), np.asarray(jneg), **STEP_TOL)
    np.testing.assert_allclose(float(loss), float(jloss), **STEP_TOL)
    score = tgn.link_score(tparams, out.emb_src, torch.as_tensor(neg))
    np.testing.assert_allclose(
        score.numpy(), np.asarray(jtgn.link_score(params, jout.emb_src,
                                                  jnp.asarray(neg))),
        **STEP_TOL)
    assert score.shape == (B,)


# ---------------------------------------------------------------------------
# the engine with node features; step_on_device
# ---------------------------------------------------------------------------


def _gdelt_engine(tier, n_edges=150):
    g = tgd.gdelt_like(n_edges=n_edges)
    dims = dict(n_nodes=g.cfg.n_nodes, n_edges=g.n_edges, f_edge=0,
                f_feat=200, f_mem=8, f_time=8, f_emb=8)
    params = tpl.build_pipeline("sat+lut+np4", device="cpu",
                                **dims).init_params()
    return g, dims, params, StreamingEngine.from_variant(
        "sat+lut+np4", params, g.edge_feats, g.node_feats,
        use_kernels=tier, device="cpu", **dims)


def test_engine_with_node_features_reports_fused_as_staged():
    g, dims, params, eng = _gdelt_engine("fused")
    d = eng.describe()
    assert d["use_kernels"] == "fused" and d["tier"] == "staged"
    assert "fused_step" not in d and d["memory_updater"] == "gru:lut-cuda"
    assert eng.pipeline.tier == "staged"
    pipe = tpl.TGNPipeline(eng.cfg.model, "staged", device="cpu")
    aux, state = pipe.prepare(eng.params), pipe.init_state()
    for host, (es, ed) in eng.run(stream.fixed_count(g, 30)):
        tb = tuple(torch.as_tensor(x) for x in
                   (host.src, host.dst, host.eid, host.ts, host.valid))
        out = pipe.step(eng.params, aux, state, tb, eng.edge_feats,
                        eng.node_feats)
        state = out.state
        assert torch.equal(es, out.emb_src) and torch.equal(ed, out.emb_dst)
    assert eng.summary()["batches"] == 4


@pytest.mark.parametrize("node_feats", ["missing", "wrong_width"])
def test_engine_checks_node_feature_shape(node_feats):
    g, dims, params, _ = _gdelt_engine("staged", n_edges=40)
    nf = None if node_feats == "missing" else g.node_feats[:, :199]
    with pytest.raises(ValueError, match="node_feats must be"):
        StreamingEngine.from_variant("sat+lut+np4", params, g.edge_feats,
                                     nf, device="cpu", **dims)


@pytest.mark.parametrize("tier", ["ref", "staged", "fused"])
def test_step_on_device_leaves_state_and_metrics_unchanged(tier):
    g, dims, params, eng = _gdelt_engine(tier)
    batches = list(stream.fixed_count(g, 30))
    eng.process(batches[0])
    before = {f: getattr(eng.state, f).clone() for f in eng.state._fields}
    metrics_before = list(eng.metrics)
    dev = tuple(torch.as_tensor(x) for x in
                (batches[1].src, batches[1].dst, batches[1].eid,
                 batches[1].ts, batches[1].valid))
    peek = eng.step_on_device(dev)
    for f, t in before.items():
        assert torch.equal(getattr(eng.state, f), t), f
    assert eng.metrics == metrics_before
    es, ed = eng.process(batches[1])      # the same step, committed
    assert torch.equal(es, peek.emb_src) and torch.equal(ed, peek.emb_dst)
    for f in peek.state._fields:
        assert torch.equal(getattr(eng.state, f), getattr(peek.state, f))
    eng.state = peek.state                # settable
    assert eng.state is peek.state


# ---------------------------------------------------------------------------
# entry points on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier,resolved", [("ref", "ref"),
                                           ("staged", "staged"),
                                           ("fused", "staged")])
def test_serve_cli_serves_gdelt_on_cpu(tier, resolved, capsys):
    serve.main(["--device", "cpu", "--dataset", "gdelt", "--edges", "300",
                "--batch", "100", "--f-mem", "8", "--kernels", tier])
    out = capsys.readouterr().out
    assert f"'use_kernels': '{tier}'" in out
    assert f"'tier': '{resolved}'" in out
    assert "engine summary:" in out


def test_streaming_example_runs_on_cpu():
    # one intra-op thread in the example's process: with the default (a
    # thread a core) and the other test workers on those cores, every
    # small op's thread team waits for descheduled threads, and the same
    # run takes over 600 s instead of ~10 s
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           **ONE_THREAD}
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples",
                                      "streaming_inference_torch.py"),
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr
    assert "windows processed" in out.stdout
    assert "p99 latency" in out.stdout

