"""The port's scaffolding against the JAX package: data layer, converters,
device rules, imports, and the table updates whose semantics are easy to
get wrong in torch (ring insert of hot vertices, top-k ties, last write
wins)."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mailbox as jmailbox
from repro.core import pipeline as jpl
from repro.core import pruning as jpruning
from repro.core import updater as jupdater
from repro.data import stream as jstream
from repro.data import temporal_graph as jtgd

from repro_torch import convert
from repro_torch.core import mailbox, pruning, stages, updater
from repro_torch.core import pipeline as tpl
from repro_torch.data import stream, temporal_graph as tgd
from repro_torch.kernels import build, ops
from repro_torch.launch import serve
from repro_torch.serving.engine import EngineConfig, StreamingEngine
from repro_torch.utils import resolve_device

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


# ---------------------------------------------------------------------------
# data layer: array-equal to the reference for the same seed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,seed", [("wikipedia", 0), ("wikipedia", 5),
                                       ("reddit", 1), ("reddit", 2)])
def test_graph_generators_are_array_equal(name, seed):
    want = jtgd.DATASETS[name](n_edges=700, seed=seed)
    got = tgd.DATASETS[name](n_edges=700, seed=seed)
    for f in ("src", "dst", "ts", "edge_feats", "node_feats"):
        a, b = getattr(got, f), getattr(want, f)
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
            assert a.dtype == b.dtype
    assert got.cfg.asdict() == want.cfg.asdict()


def test_fixed_count_batches_are_array_equal():
    jg = jtgd.wikipedia_like(n_edges=530, seed=3)
    g = tgd.wikipedia_like(n_edges=530, seed=3)
    pairs = [(stream.fixed_count(g, 64, window=slice(10, 500), seed=4),
              jstream.fixed_count(jg, 64, window=slice(10, 500), seed=4)),
             (stream.fixed_count(g, 200), jstream.fixed_count(jg, 200))]
    for ours, theirs in pairs:
        ours, theirs = list(ours), list(theirs)
        assert len(ours) == len(theirs) > 1
        for a, b in zip(ours, theirs):
            for f in stream.EdgeBatch._fields:
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


# ---------------------------------------------------------------------------
# converters
# ---------------------------------------------------------------------------


def test_params_and_state_round_trip():
    dims = dict(n_nodes=50, n_edges=80, f_edge=12, f_mem=8, f_time=8,
                f_emb=8)
    jpipe = jpl.build_pipeline("sat+lut+np4", **dims)
    ref = jax.tree.map(np.asarray, jpipe.init_params(jax.random.key(4)))
    params = convert.params_from_reference(ref, "cpu")
    back = convert.params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    # the port's own init has the reference's layout
    own = tpl.build_pipeline("sat+lut+np4", device="cpu",
                             **dims).init_params()
    assert (jax.tree.map(lambda x: tuple(x.shape),
                         convert.params_to_numpy(own))
            == jax.tree.map(lambda x: tuple(x.shape), ref))
    jstate = jax.tree.map(np.asarray, jpipe.init_state())
    state = convert.state_from_reference(jstate, "cpu")
    for f, a in convert.state_to_numpy(state).items():
        np.testing.assert_array_equal(a, getattr(jstate, f))
        assert a.dtype == getattr(jstate, f).dtype


# ---------------------------------------------------------------------------
# no silent CPU; no JAX in the port
# ---------------------------------------------------------------------------


def test_entry_points_without_device_refuse_to_run_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tpl.variant_config("sat+lut+np4", n_nodes=20, n_edges=30,
                             f_edge=4, f_mem=4, f_time=4, f_emb=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpl.TGNPipeline(cfg, "fused")
    params = tpl.TGNPipeline(cfg, device="cpu").init_params()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamingEngine(EngineConfig(model=cfg), params,
                        np.zeros((30, 4), np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--edges", "300", "--f-mem", "4"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_wrapper_on_a_device_tensor_launches_or_raises(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel, never to the
    plain version: with no library to launch, the call raises."""
    def no_library():
        raise RuntimeError("no kernel library")
    monkeypatch.setattr(build, "library", no_library)
    dt = torch.empty(8, device="meta")
    packed = {"bounds": torch.empty(4, device="meta"),
              "table": torch.empty((4, 3), device="meta")}
    with pytest.raises(RuntimeError, match="no kernel library"):
        ops.lut_encode(dt, packed)


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "lm = ['repro_torch.models.transformer', 'repro_torch.models.moe',"
        " 'repro_torch.models.mamba2', 'repro_torch.models.rglru',"
        " 'repro_torch.models.whisper', 'repro_torch.models.vision_lm',"
        " 'repro_torch.configs.qwen3_8b', 'repro_torch.serving.lm_serve']\n"
        "assert all(m in sys.modules for m in lm), lm\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = {**os.environ, "PYTHONPATH": os.path.abspath(SRC),
           "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20       # every module was imported


# ---------------------------------------------------------------------------
# table updates with torch-specific traps
# ---------------------------------------------------------------------------


def test_ring_insert_of_hot_vertex_matches_reference():
    """Vertex 3 is inserted over 20 times in one batch, so its slots wrap
    twice within the batch; padding rows must write nothing."""
    V, mr, B = 12, 10, 60
    rng = np.random.RandomState(0)
    src = np.where(rng.rand(B) < 0.6, 3, rng.randint(0, V, B)).astype(
        np.int32)
    dst = rng.randint(0, V, B).astype(np.int32)
    eid = np.arange(B, dtype=np.int32) + 100
    ts = np.sort(rng.rand(B)).astype(np.float32) * 1e3
    valid = rng.rand(B) > 0.2
    cfg = dict(n_nodes=V, f_mem=4, f_edge=4, m_r=mr)
    jstate = jmailbox.init_state(jmailbox.TableConfig(**cfg))
    state = mailbox.init_state(mailbox.TableConfig(**cfg), "cpu")
    for _ in range(2):                         # a second batch on top
        jstate = jmailbox.insert_neighbors(
            jstate, *map(jnp.asarray, (src, dst, eid, ts, valid)))
        state = mailbox.insert_neighbors(
            state, *map(torch.as_tensor, (src, dst, eid, ts, valid)))
        assert ((src == 3) & valid).sum() > 2 * mr
        for f in ("nbr_ids", "nbr_ts", "nbr_eid", "nbr_cursor"):
            np.testing.assert_array_equal(getattr(state, f).numpy(),
                                          np.asarray(getattr(jstate, f)),
                                          err_msg=f)
        vids = np.arange(V, dtype=np.int32)
        for a, b in zip(mailbox.gather_neighbors(state, torch.as_tensor(vids)),
                        jmailbox.gather_neighbors(jstate, jnp.asarray(vids))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_topk_ties_keep_lowest_index_like_reference():
    logits = np.array([[1.0, 2.0, 2.0, 0.5, 2.0, 1.0],
                       [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                       [3.0, 1.0, 3.0, 1.0, 3.0, 1.0],
                       [5.0, 4.0, 3.0, 2.0, 1.0, 0.0]], np.float32)
    valid = np.array([[1, 1, 1, 1, 1, 1], [1, 0, 1, 0, 1, 1],
                      [0, 0, 0, 0, 0, 0], [0, 1, 0, 1, 1, 1]], bool)
    for k in (1, 3, 4):
        want = jpruning.topk_select(jnp.asarray(logits), jnp.asarray(valid),
                                    k)
        got = pruning.topk_select(torch.as_tensor(logits),
                                  torch.as_tensor(valid), k)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_last_write_wins_and_commit_match_reference():
    rng = np.random.RandomState(1)
    B = 30
    ids = rng.randint(0, 9, 2 * B).astype(np.int32)
    valid = rng.rand(2 * B) > 0.25
    want = jupdater.last_write_wins(jnp.asarray(ids), jnp.asarray(valid),
                                    jupdater.interleave_order(B))
    got = updater.last_write_wins(torch.as_tensor(ids),
                                  torch.as_tensor(valid),
                                  updater.interleave_order(B, "cpu"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    table = rng.randn(9, 3).astype(np.float32)
    values = rng.randn(2 * B, 3).astype(np.float32)
    np.testing.assert_array_equal(
        updater.commit(torch.as_tensor(table), torch.as_tensor(ids),
                       torch.as_tensor(values), got).numpy(),
        np.asarray(jupdater.commit(jnp.asarray(table), jnp.asarray(ids),
                                   jnp.asarray(values), want)))


# ---------------------------------------------------------------------------
# tiers: each prepares and builds only what it runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant,tier,packs,muu", [
    ("sat+lut+np4", "ref", set(), True),
    ("sat+lut+np4", "staged",
     {"packed_gru", "packed_lut_gru", "packed_sat"}, True),
    ("sat+lut+np4", "fused", {"packed_sat", "packed_fused"}, False),
    ("sat+cosine", "ref", None, True),
    ("sat+cosine", "staged", None, True),
    ("sat+cosine", "fused", None, True),
    ("vanilla+cosine", "ref", None, True),
    ("vanilla+cosine", "staged", None, True),
    ("vanilla+cosine", "fused", None, True)])
def test_tier_builds_only_what_it_runs(variant, tier, packs, muu):
    """Every tier builds the sampler and aggregator (``embed`` runs them;
    on the fused tier they are the staged ones, with ``packed_sat``); the
    memory updater only where ``step`` runs it, the fused body only on the
    fused tier. The cosine variants (``packs`` None) prepare nothing and
    run their torch stages on every tier; a fused request runs the staged
    tier."""
    cfg = tpl.variant_config(variant, n_nodes=20, n_edges=30,
                             f_edge=4, f_mem=4, f_time=4, f_emb=4)
    pipe = tpl.TGNPipeline(cfg, tier, device="cpu")
    cosine = packs is None
    assert pipe.tier == ("staged" if cosine and tier == "fused" else tier)
    aux = pipe.prepare(pipe.init_params())
    assert set(aux) == (set() if cosine else
                        {"folded_gru", "folded_attn"} | packs)
    st = pipe.stages
    assert (st.fused is None) == muu
    assert (st.memory_updater is not None) == muu
    assert st.sampler is not None and st.aggregator is not None
    staged = tier != "ref"
    if cosine:
        attn = "vanilla" if variant.startswith("vanilla") else "sat-cosine"
        assert st.names["aggregator"] == f"attn:{attn}-ref"
        assert st.names["memory_updater"] == "gru:cosine-ref"
    else:
        assert st.names["aggregator"] == ("attn:sat-lut-cuda" if staged
                                          else "attn:sat-lut-ref")


def _tiny(variant, **kw):
    return tpl.variant_config(variant, n_nodes=20, n_edges=30, f_edge=4,
                              f_mem=4, f_time=4, f_emb=4).replace(**kw)


@pytest.mark.parametrize("cfg,tiers,match", [
    (_tiny("teacher", encoder="lut"), stages.KERNEL_TIERS,
     "requires the cosine encoder"),
    (_tiny("teacher", sampler="uniform"), stages.KERNEL_TIERS,
     "require SAT attention"),
    (_tiny("sat+lut+np4", sampler="bogus"), stages.KERNEL_TIERS,
     "unknown sampler backend"),
    (_tiny("sat+lut+np4"), ("bogus", "Fused"), "unknown kernel tier")])
def test_reference_refusals_hold_on_every_tier(cfg, tiers, match):
    """What the reference refuses, the port refuses, on every tier: vanilla
    attention with the LUT encoder or a randomized sampler, an unknown
    sampler, an unknown tier. Nothing else is refused."""
    for tier in tiers:
        with pytest.raises(ValueError, match=match):
            jpl.TGNPipeline(jpl.tgn.TGNConfig(**cfg.asdict()), tier)
        with pytest.raises(ValueError, match=match):
            tpl.TGNPipeline(cfg, tier, device="cpu")


def test_static_node_features_are_served_with_fused_resolving_to_staged():
    """f_feat > 0 runs on every tier; the fused step does not cover it,
    so a fused request runs the staged tier, as in the reference."""
    cfg = tpl.variant_config("sat+lut+np4", n_nodes=20, n_edges=30,
                             f_edge=4, f_mem=4, f_time=4,
                             f_emb=4).replace(f_feat=3)
    assert not stages.fused_supported(cfg)
    for tier, want in (("ref", "ref"), ("staged", "staged"),
                       ("fused", "staged"), (True, "staged")):
        assert stages.resolved_tier(cfg, tier) == want
        assert jpl.stages.resolved_tier(cfg, tier) == want
        pipe = tpl.TGNPipeline(cfg, tier, device="cpu")
        assert pipe.tier == want and pipe.stages.fused is None
        assert pipe.describe()["tier"] == want


# ---------------------------------------------------------------------------
# engine and CLI on the CPU
# ---------------------------------------------------------------------------


def test_engine_is_the_pipeline_step_with_metrics():
    g = tgd.wikipedia_like(n_edges=120)
    dims = dict(n_nodes=g.cfg.n_nodes, n_edges=g.n_edges, f_edge=172,
                f_mem=8, f_time=8, f_emb=8, m_r=10)
    pipe = tpl.build_pipeline("sat+lut+np4", use_kernels="fused",
                              device="cpu", **dims)
    params = pipe.init_params(torch.Generator().manual_seed(1))
    eng = StreamingEngine.from_variant("student", params, g.edge_feats,
                                       use_kernels="fused", device="cpu",
                                       **dims)
    assert eng.describe()["tier"] == "fused"
    aux, state = pipe.prepare(params), pipe.init_state()
    ef = torch.as_tensor(g.edge_feats)
    for host, (emb_src, emb_dst) in eng.run(stream.fixed_count(g, 30)):
        batch = tuple(torch.as_tensor(x) for x in
                      (host.src, host.dst, host.eid, host.ts, host.valid))
        out = pipe.step(params, aux, state, batch, ef)
        state = out.state
        torch.testing.assert_close(emb_src, out.emb_src, rtol=0, atol=0)
        torch.testing.assert_close(emb_dst, out.emb_dst, rtol=0, atol=0)
    for f in mailbox.VertexState._fields:
        assert torch.equal(getattr(eng.state, f), getattr(state, f)), f
    summary = eng.summary()
    assert set(summary) == {"batches", "mean_latency_ms", "p99_latency_ms",
                            "mean_h2d_ms", "throughput_eps"}
    assert summary["batches"] == 3 and summary["throughput_eps"] > 0


def test_engine_rejects_out_of_range_ids():
    g = tgd.wikipedia_like(n_edges=60)
    eng = StreamingEngine.from_variant(
        "sat+lut+np4", tpl.build_pipeline(
            "sat+lut+np4", device="cpu", n_nodes=g.cfg.n_nodes, n_edges=60,
            f_mem=4, f_time=4, f_emb=4).init_params(),
        g.edge_feats, device="cpu", n_nodes=g.cfg.n_nodes, n_edges=60,
        f_mem=4, f_time=4, f_emb=4)
    b = next(stream.fixed_count(g, 20))
    with pytest.raises(ValueError, match="eid out of range"):
        eng.process(b._replace(eid=b.eid + 60))


@pytest.mark.parametrize("tier", ["ref", "staged", "fused"])
def test_serve_cli_runs_on_cpu(tier, capsys):
    serve.main(["--device", "cpu", "--edges", "300", "--batch", "100",
                "--f-mem", "8", "--kernels", tier])
    out = capsys.readouterr().out
    assert "engine stages:" in out and f"'tier': '{tier}'" in out
    assert "engine summary:" in out
