"""The port's sat+lut+np4 trajectories against the JAX package.

Twenty chronological batches (one of them half padding) go through the
port's ``ref``, ``staged`` and ``fused`` tiers on the CPU, and through the
reference: ``repro.core.tgn.process_batch`` and the reference's staged and
fused pipelines, whose Pallas kernels run in interpret mode here. The
weights are the reference's, carried across with
``repro_torch.convert.params_from_reference``.

Tolerances. Integer and bool tables must be equal. Floats are fp32 on both
sides but summed in other orders by different matmul libraries, so a step
taken from the same input state agrees to ~1e-6; we hold it to
rtol = atol = 1e-5. Over the whole trajectory each side feeds on its own
state, the GRU recurrence carries the rounding forward, and we hold the
float tables and embeddings to 1e-4.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import pipeline as jpl
from repro.core import tgn as jtgn
from repro.data import stream as jstream
from repro.data import temporal_graph as jtgd

from repro_torch import convert
from repro_torch.core import pipeline as tpl
from repro_torch.kernels import ops as kops

torch.set_num_threads(1)

F = 16                  # f_mem = f_time = f_emb
B = 15                  # batch size
N_BATCHES = 20
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)
INT_FIELDS = ("mail_valid", "nbr_ids", "nbr_eid", "nbr_cursor")
FLOAT_FIELDS = ("memory", "last_update", "mail", "mail_ts", "nbr_ts")


def _setup():
    g = jtgd.wikipedia_like(n_edges=N_BATCHES * B)
    dims = dict(n_nodes=g.cfg.n_nodes, n_edges=g.n_edges, f_edge=172,
                f_mem=F, f_time=F, f_emb=F, m_r=10)
    jcfg = jpl.variant_config("sat+lut+np4", **dims)
    params = jpl.build_pipeline(jcfg).init_params(jax.random.key(0))
    batches = []
    for i, b in enumerate(jstream.fixed_count(g, B)):
        valid = np.asarray(b.valid).copy()
        if i == 3:
            valid[B // 2:] = False        # a ragged batch: half padding
        batches.append((b.src, b.dst, b.eid, b.ts, valid))
    return g, jcfg, dims, params, batches


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_step(jcfg, tier):
    if tier == "process_batch":
        def step(params, state, batch, ef):
            return jtgn.process_batch(params, jcfg, state, None, ef, *batch)
        return jax.jit(step)
    return jax.jit(jpl.build_pipeline(jcfg, use_kernels=tier).step_fn)


def _check_state(got, want, tol, where):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)),
                                      err_msg=f"{where}: {f}")
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(got[f], np.asarray(getattr(want, f)),
                                   err_msg=f"{where}: {f}", **tol)


@pytest.mark.parametrize("tier,jax_tier", [
    ("ref", "process_batch"),
    ("ref", "staged"),
    ("staged", "staged"),
    ("fused", "fused"),
])
def test_trajectory_matches_reference(tier, jax_tier):
    g, jcfg, dims, params, batches = _setup()
    jstep = _jax_step(jcfg, jax_tier)
    ef = jax.numpy.asarray(g.edge_feats)
    pipe = tpl.build_pipeline("sat+lut+np4", use_kernels=tier, device="cpu",
                              **dims)
    assert pipe.tier == tier
    tparams = convert.params_from_reference(_np(params), "cpu")
    aux = pipe.prepare(tparams)
    tef = torch.as_tensor(g.edge_feats)
    jstate = jpl.build_pipeline(jcfg).init_state()
    tstate = pipe.init_state()
    for i, batch in enumerate(batches):
        tb = tuple(torch.as_tensor(np.asarray(x)) for x in batch)
        # one step from the reference's own input state
        jout = jstep(params, jstate, tuple(map(jax.numpy.asarray, batch)),
                     ef)
        one = pipe.step(tparams, aux,
                        convert.state_from_reference(_np(jstate), "cpu"),
                        tb, tef)
        for name in ("emb_src", "emb_dst", "attn_logits", "nbr_dt"):
            np.testing.assert_allclose(
                getattr(one, name).numpy(), np.asarray(getattr(jout, name)),
                err_msg=f"step {i}: {name}", **STEP_TOL)
        np.testing.assert_array_equal(one.nbr_valid.numpy(),
                                      np.asarray(jout.nbr_valid))
        _check_state(convert.state_to_numpy(one.state), jout.state,
                     STEP_TOL, f"step {i}")
        # the port's own trajectory
        tout = pipe.step(tparams, aux, tstate, tb, tef)
        for name in ("emb_src", "emb_dst"):
            np.testing.assert_allclose(
                getattr(tout, name).numpy(), np.asarray(getattr(jout, name)),
                err_msg=f"trajectory step {i}: {name}", **TRAJ_TOL)
        jstate, tstate = jout.state, tout.state
        _check_state(convert.state_to_numpy(tstate), jstate, TRAJ_TOL,
                     f"trajectory step {i}")
    # the trajectory exercised what it is meant to: cached mail consumed,
    # rings wrapped by hot vertices, and no device launches on the CPU
    final = convert.state_to_numpy(tstate)
    assert final["mail_valid"].any()
    assert final["nbr_cursor"].max() > 10
    assert sum(kops.LAUNCHES.values()) == 0
