"""The serve CLI's ``--window-s`` on the port: the engine fed the stream's
wall-clock windows (``stream.time_window``), against the JAX package's
engine over the same windows.

The reference's engine (its ref tier, jitted) and the port's on each tier
serve the same windows from the same weights: the same number of windows,
and every window's embeddings (valid rows) within the trajectory tests'
tolerance, rtol = atol = 1e-4 (tests/test_torch_trajectory.py: each side
feeds on its own state and the GRU carries the rounding forward).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as jpl
from repro.data import stream as jstream
from repro.data import temporal_graph as jtgd
from repro.serving import engine as jengine

from repro_torch import convert
from repro_torch.core import pipeline as tpl
from repro_torch.data import stream, temporal_graph as tgd
from repro_torch.launch import serve
from repro_torch.serving.engine import EngineConfig, StreamingEngine

torch.set_num_threads(1)

N_EDGES, F, MAX_BATCH, WINDOW_S = 600, 8, 64, 900.0
TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)


def _windows(g):
    return list(jstream.time_window(g, WINDOW_S, MAX_BATCH))


def test_window_s_serves_one_batch_a_window(capsys):
    """The CLI with ``--window-s``: one engine batch a window of the
    reference's ``time_window``, ragged widths up to ``--batch``."""
    summary = serve.main(["--device", "cpu", "--edges", str(N_EDGES),
                          "--batch", str(MAX_BATCH), "--f-mem", str(F),
                          "--window-s", str(WINDOW_S), "--kernels", "fused"])
    windows = _windows(jtgd.wikipedia_like(n_edges=N_EDGES))
    widths = {int(np.asarray(b.valid).sum()) for b in windows}
    assert len(widths) > 5 and max(widths) <= MAX_BATCH
    # summary() counts every batch after the first
    assert summary["batches"] == len(windows) - 1
    assert "engine summary:" in capsys.readouterr().out
    fixed = serve.main(["--device", "cpu", "--edges", str(N_EDGES),
                        "--batch", str(MAX_BATCH), "--f-mem", str(F)])
    assert fixed["batches"] == -(-N_EDGES // MAX_BATCH) - 1


@pytest.mark.parametrize("tier", ["ref", "staged", "fused"])
def test_windowed_engine_matches_the_reference(tier):
    jg = jtgd.wikipedia_like(n_edges=N_EDGES)
    g = tgd.wikipedia_like(n_edges=N_EDGES)
    dims = dict(n_nodes=g.cfg.n_nodes, n_edges=g.n_edges, f_edge=172,
                f_mem=F, f_time=F, f_emb=F, m_r=10)
    jcfg = jpl.variant_config("sat+lut+np4", **dims)
    params = jpl.build_pipeline(jcfg).init_params(jax.random.key(0))
    jeng = jengine.StreamingEngine(
        jengine.EngineConfig(model=jcfg, use_kernels="ref"), params,
        jnp.asarray(jg.edge_feats))
    want = [(np.asarray(b.valid), np.asarray(hs), np.asarray(hd))
            for b, (hs, hd) in jeng.run(jstream.time_window(
                jg, WINDOW_S, MAX_BATCH))]
    tparams = convert.params_from_reference(
        jax.tree.map(np.asarray, params), "cpu")
    eng = StreamingEngine(EngineConfig(model=tpl.variant_config(
        "sat+lut+np4", **dims), use_kernels=tier), tparams, g.edge_feats,
        device="cpu")
    got = [(b.valid, hs.numpy(), hd.numpy())
           for b, (hs, hd) in eng.run(stream.time_window(g, WINDOW_S,
                                                         MAX_BATCH))]
    assert len(got) == len(want) == len(_windows(jg))
    assert eng.summary()["batches"] == jeng.summary()["batches"]
    for i, ((v, hs, hd), (jv, jhs, jhd)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_allclose(hs[v], jhs[jv], err_msg=f"window {i}",
                                   **TRAJ_TOL)
        np.testing.assert_allclose(hd[v], jhd[jv], err_msg=f"window {i}",
                                   **TRAJ_TOL)
