"""The rest of the Table-II ladder in the port, against the JAX package: the
teacher ``vanilla+cosine``, ``sat+cosine``, the ``sat+lut`` rungs and the
np4 student's ``uniform`` and ``reservoir`` samplers.

Every variant of the reference's ``VARIANTS`` and ``SAMPLER_VARIANTS``
runs a one-step check and a 20-batch trajectory on each of the port's
tiers, against ``repro.core.tgn.process_batch`` (ref tier) and the
reference's staged and fused pipelines, whose Pallas kernels run in
interpret mode here. A fused request outside the fused step's coverage
(the cosine variants) runs the staged tier on both sides. The module
tests (cosine encoder, full GRU cell, vanilla attention, the stateless
hash, the selection policies, the registry and the complexity model) hold
each piece against its reference.

Tolerances, as in tests/test_torch_trajectory.py: integer and bool tables
and selections must be equal; a step from the same input state agrees to
rtol = atol = 1e-5 (fp32 sums in other orders); over a 20-batch
trajectory the GRU carries the rounding forward, so 1e-4. The hash draws
must be equal bit for bit. Reservoir priorities, log(u) * exp(dt / tau),
differ by an ulp between XLA and torch in some entries, so they are held
to rtol = 1e-6 and the winners they select to equality.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention as jattn
from repro.core import complexity as jcx
from repro.core import memory as jmemory
from repro.core import pipeline as jpl
from repro.core import pruning as jpruning
from repro.core import stages as jstages
from repro.core import tgn as jtgn
from repro.core import time_encode as jte
from repro.data import stream as jstream
from repro.data import temporal_graph as jtgd
from repro.serving import engine as jengine

from repro_torch import convert
from repro_torch.core import attention, complexity, memory, pruning, stages
from repro_torch.core import pipeline as tpl
from repro_torch.core import tgn
from repro_torch.core import time_encode as te
from repro_torch.data import stream, temporal_graph as tgd
from repro_torch.kernels import ops as kops
from repro_torch.serving import engine
from repro_torch.serving.engine import StreamingEngine

torch.set_num_threads(1)

F = 16                  # f_mem = f_time = f_emb
B = 40                  # batch size
N_BATCHES = 20
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)
PRIO_RTOL = 1e-6
INT_FIELDS = ("mail_valid", "nbr_ids", "nbr_eid", "nbr_cursor")
FLOAT_FIELDS = ("memory", "last_update", "mail", "mail_ts", "nbr_ts")
LADDER = jpl.VARIANTS + jpl.SAMPLER_VARIANTS[1:]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.as_tensor(np.array(x))


def _graph():
    g = jtgd.wikipedia_like(n_edges=N_BATCHES * B)
    dims = dict(n_nodes=g.cfg.n_nodes, n_edges=g.n_edges, f_edge=172,
                f_mem=F, f_time=F, f_emb=F, m_r=10)
    batches = []
    for i, b in enumerate(jstream.fixed_count(g, B)):
        valid = np.asarray(b.valid).copy()
        if i == 3:
            valid[B // 2:] = False        # a ragged batch: half padding
        batches.append((b.src, b.dst, b.eid, b.ts, valid))
    return g, dims, batches


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


def _jax_names(d):
    """The reference's describe() in the port's words: its kernel stages
    are the port's CUDA stages."""
    return {k: (v.replace("-pallas", "-cuda") if isinstance(v, str) else v)
            for k, v in d.items()}


# ---------------------------------------------------------------------------
# every variant on every tier: one step and a 20-batch trajectory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier,jax_tier", [("ref", "process_batch"),
                                           ("staged", "staged"),
                                           ("fused", "fused")])
@pytest.mark.parametrize("variant", LADDER)
def test_ladder_trajectory_matches_reference(variant, tier, jax_tier):
    g, dims, batches = _graph()
    jcfg = jpl.variant_config(variant, **dims)
    jpipe = jpl.build_pipeline(jcfg, use_kernels=jax_tier
                               if jax_tier != "process_batch" else "ref")
    params = jpipe.init_params(jax.random.key(0))
    jstep = _jax_step(jcfg, jax_tier)
    ef = jnp.asarray(g.edge_feats)
    pipe = tpl.build_pipeline(variant, use_kernels=tier, device="cpu",
                              **dims)
    # the resolved tier and stage names are the reference's
    assert pipe.tier == jpipe.tier
    want = _jax_names(jpipe.describe())
    got = pipe.describe()
    for key in ("variant", "use_kernels", "tier", "sampler", "aggregator",
                "committer", "fused_step"):
        assert got.get(key) == want.get(key), key
    # the port's fused tier builds no per-unit memory updater
    assert got.get("memory_updater") == (
        None if pipe.tier == "fused" else want["memory_updater"])
    tparams = convert.params_from_reference(_np(params), "cpu")
    aux = pipe.prepare(tparams)
    if jcfg.encoder == "cosine":
        assert aux == {}
    tef = torch.as_tensor(g.edge_feats)
    jstate = jpipe.init_state()
    tstate = pipe.init_state()
    for i, batch in enumerate(batches):
        tb = tuple(_t(x) for x in batch)
        jout = jstep(params, jstate, tuple(map(jnp.asarray, batch)), ef)
        one = pipe.step(tparams, aux,
                        convert.state_from_reference(_np(jstate), "cpu"),
                        tb, tef)
        # attn_logits: the teacher's head-mean scores, SAT's full logits
        for name in ("emb_src", "emb_dst", "attn_logits", "nbr_dt"):
            np.testing.assert_allclose(
                getattr(one, name).numpy(), np.asarray(getattr(jout, name)),
                err_msg=f"step {i}: {name}", **STEP_TOL)
        np.testing.assert_array_equal(one.nbr_valid.numpy(),
                                      np.asarray(jout.nbr_valid))
        _check_state(convert.state_to_numpy(one.state), jout.state,
                     STEP_TOL, f"step {i}")
        tout = pipe.step(tparams, aux, tstate, tb, tef)
        for name in ("emb_src", "emb_dst", "attn_logits"):
            np.testing.assert_allclose(
                getattr(tout, name).numpy(), np.asarray(getattr(jout, name)),
                err_msg=f"trajectory step {i}: {name}", **TRAJ_TOL)
        jstate, tstate = jout.state, tout.state
        _check_state(convert.state_to_numpy(tstate), jstate, TRAJ_TOL,
                     f"trajectory step {i}")
    final = convert.state_to_numpy(tstate)
    assert final["mail_valid"].any()
    assert final["nbr_cursor"].max() > 10
    assert sum(kops.LAUNCHES.values()) == 0


def test_every_name_and_alias_builds_and_steps_on_every_tier():
    g = tgd.wikipedia_like(n_edges=60)
    dims = dict(n_nodes=g.cfg.n_nodes, n_edges=g.n_edges, f_edge=172,
                f_mem=4, f_time=4, f_emb=4, m_r=10)
    b = next(stream.fixed_count(g, 30))
    batch = tuple(_t(x) for x in (b.src, b.dst, b.eid, b.ts, b.valid))
    ef = torch.as_tensor(g.edge_feats)
    names = list(jpl.VARIANTS + jpl.SAMPLER_VARIANTS) + sorted(jpl._ALIASES)
    for name in names:
        for tier in stages.KERNEL_TIERS:
            pipe = tpl.build_pipeline(name, use_kernels=tier, device="cpu",
                                      **dims)
            jpipe = jpl.build_pipeline(name, use_kernels=tier, **dims)
            assert pipe.variant == jpipe.variant, name
            assert pipe.tier == jpipe.tier, (name, tier)
            params = pipe.init_params(torch.Generator().manual_seed(1))
            out = pipe.step_fn(params, pipe.init_state(), batch, ef)
            assert torch.isfinite(out.emb_src).all(), (name, tier)


# ---------------------------------------------------------------------------
# modules: cosine encoder, full GRU, vanilla attention
# ---------------------------------------------------------------------------


def test_cosine_encoder_and_lut_from_it_match_reference():
    cfg = jte.TimeEncoderConfig(dim=100, n_entries=128)
    jp = jte.init_cosine(jax.random.key(0), cfg)
    tp = te.init_cosine(te.TimeEncoderConfig(dim=100, n_entries=128), "cpu")
    for k in ("omega", "phi"):
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    dt = (10 ** np.random.RandomState(0).uniform(-2, 7, 5000)).astype(
        np.float32)
    dt[:3] = (0.0, 1e7, 3.5)
    np.testing.assert_allclose(te.cosine_encode(tp, _t(dt)).numpy(),
                               np.asarray(jte.cosine_encode(jp, dt)),
                               **STEP_TOL)
    jl = jte.init_lut(jax.random.key(1), cfg, cosine_params=jp)
    tl = te.init_lut(torch.Generator().manual_seed(1),
                     te.TimeEncoderConfig(dim=100, n_entries=128), "cpu",
                     cosine_params=tp)
    np.testing.assert_array_equal(tl["boundaries"].numpy(),
                                  np.asarray(jl["boundaries"]))
    np.testing.assert_allclose(tl["table"].numpy(), np.asarray(jl["table"]),
                               **STEP_TOL)


def test_full_gru_cell_and_cosine_update_match_reference():
    rng = np.random.RandomState(2)
    gcfg = jmemory.GRUConfig(f_mem=16, f_edge=24, f_time=16)
    jp = _np(jmemory.init_gru(jax.random.key(3), gcfg))
    tp = convert.params_from_reference(jp, "cpu")
    time_p = _np(jte.init_cosine(None, jte.TimeEncoderConfig(dim=16)))
    n = 33
    mail_raw = rng.randn(n, gcfg.f_mail_raw).astype(np.float32)
    s = rng.randn(n, 16).astype(np.float32)
    ts = (rng.rand(n) * 1e5).astype(np.float32)
    lu = (ts * rng.rand(n)).astype(np.float32)
    ok = rng.rand(n) > 0.3
    mail = rng.randn(n, gcfg.f_mail).astype(np.float32)
    np.testing.assert_allclose(
        memory.gru_cell(tp, _t(mail), _t(s)).numpy(),
        np.asarray(jmemory.gru_cell(jp, mail, s)), **STEP_TOL)
    want = jmemory.update_memory(jp, time_p, gcfg, mail_raw, ts, ok, s, lu,
                                 encoder="cosine")
    got = memory.update_memory(
        tp, convert.params_from_reference(time_p, "cpu"),
        memory.GRUConfig(f_mem=16, f_edge=24, f_time=16), _t(mail_raw),
        _t(ts), _t(ok), _t(s), _t(lu), encoder="cosine")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **STEP_TOL)


@pytest.mark.parametrize("n_heads,f_feat", [(2, 0), (1, 0), (4, 12)])
def test_vanilla_attention_matches_reference(n_heads, f_feat):
    rng = np.random.RandomState(n_heads)
    kw = dict(f_mem=16, f_feat=f_feat, f_edge=24, f_time=16, f_emb=16,
              n_heads=n_heads, m_r=10)
    jcfg = jattn.AttnConfig(**kw)
    jp = _np(jattn.init_vanilla(jax.random.key(4), jcfg))
    time_p = _np(jte.init_cosine(None, jte.TimeEncoderConfig(dim=16)))
    n = 21
    s_self = rng.randn(n, 16).astype(np.float32)
    f_self = rng.randn(n, f_feat).astype(np.float32) if f_feat else None
    s_nbr = rng.randn(n, 10, 16).astype(np.float32)
    e_nbr = rng.randn(n, 10, 24).astype(np.float32)
    dt = (10 ** rng.uniform(0, 6, (n, 10))).astype(np.float32)
    valid = rng.rand(n, 10) > 0.4
    valid[0] = False                      # a vertex with no neighbors
    want = jattn.vanilla_attention(jp, jcfg, time_p, s_self, f_self, s_nbr,
                                   e_nbr, dt, valid)
    got = attention.vanilla_attention(
        convert.params_from_reference(jp, "cpu"),
        attention.AttnConfig(**kw),
        convert.params_from_reference(time_p, "cpu"), _t(s_self),
        None if f_self is None else _t(f_self), _t(s_nbr), _t(e_nbr),
        _t(dt), _t(valid))
    for a, b in zip(got, want):             # h, head-mean logits
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **STEP_TOL)


def test_masked_softmax_takes_a_broadcast_mask():
    rng = np.random.RandomState(5)
    scores = (rng.randn(9, 3, 10) * 4).astype(np.float32)
    valid = rng.rand(9, 1, 10) > 0.5
    valid[2] = False                      # all invalid: zeros
    got = pruning.masked_softmax(_t(scores), _t(valid)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jpruning.masked_softmax(scores, valid)), **STEP_TOL)
    assert not got[2].any()
    assert np.all(got[~np.broadcast_to(valid, got.shape)] == 0)


def test_teacher_params_have_the_reference_layout_and_carry_across():
    dims = dict(n_nodes=30, n_edges=40, f_edge=12, f_mem=8, f_time=8,
                f_emb=8)
    for variant in ("vanilla+cosine", "sat+cosine"):
        ref = _np(jpl.build_pipeline(variant, **dims).init_params(
            jax.random.key(6)))
        params = convert.params_from_reference(ref, "cpu")
        back = convert.params_to_numpy(params)
        assert jax.tree.structure(back) == jax.tree.structure(ref)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(a, b)
        own = tpl.build_pipeline(variant, device="cpu",
                                 **dims).init_params()
        assert (jax.tree.map(lambda x: tuple(x.shape),
                             convert.params_to_numpy(own))
                == jax.tree.map(lambda x: tuple(x.shape), ref))


# ---------------------------------------------------------------------------
# samplers: the stateless hash, the selection policies, their invariants
# ---------------------------------------------------------------------------


def test_stateless_uniform_is_bitwise_the_reference():
    rng = np.random.RandomState(7)
    n, m = 400, 10
    eid = rng.randint(0, 2 ** 31 - 1, (n, m)).astype(np.int32)
    eid[0] = (0, 1, 2, 3, 2 ** 31 - 1, 7, 8, 9, 10, 11)
    vids = rng.randint(0, 2 ** 31 - 1, n).astype(np.int32)
    t = (10 ** rng.uniform(-3, 9, n)).astype(np.float32)
    t[:6] = (0.0, -0.0, -5.5, 1.0, np.float32(2 ** 24), 3.4e38)
    got = stages._stateless_uniform(_t(eid), _t(vids), _t(t)).numpy()
    want = np.asarray(jstages._stateless_uniform(
        jnp.asarray(eid), jnp.asarray(vids), jnp.asarray(t)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.min() > 0 and got.max() < 1


def _states_and_queries(variant, dims, n_states=8):
    """The reference's states along a trajectory and the next batch's
    query vertices and times."""
    g, _, batches = _graph()
    jcfg = jpl.variant_config(variant, **dims)
    params = jpl.build_pipeline(jcfg).init_params(jax.random.key(0))
    step = _jax_step(jcfg, "process_batch")
    ef = jnp.asarray(g.edge_feats)
    state = jpl.build_pipeline(jcfg).init_state()
    for batch in batches[:n_states]:
        nxt = tuple(map(jnp.asarray, batch))
        vids = jnp.concatenate([nxt[0], nxt[1]])
        t = jnp.concatenate([nxt[3], nxt[3]])
        yield jcfg, params, state, vids, t
        state = step(params, state, nxt, ef).state


@pytest.mark.parametrize("variant", ["sat+lut+np4+uniform",
                                     "sat+lut+np4+reservoir",
                                     "sat+lut+np2+reservoir",
                                     "sat+lut+uniform"])
def test_randomized_selection_matches_reference(variant):
    """The winners' ids, edge ids, dt and validity equal the reference's;
    their logits are NEG_INF where invalid."""
    g, dims, _ = _graph()
    for jcfg, params, state, vids, t in _states_and_queries(variant, dims):
        jsel, _ = jstages.make_selector(jcfg)
        tsel, _ = stages.make_selector(tpl.variant_config(variant, **dims))
        want = jsel(params, {}, state, vids, t)
        got = tsel(convert.params_from_reference(_np(params), "cpu"), {},
                   convert.state_from_reference(_np(state), "cpu"),
                   _t(vids), _t(t))
        for f in ("ids", "eids", "valid", "dt", "full_valid", "full_dt"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
        for f in ("logits", "full_logits"):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(want, f)),
                                       err_msg=f, **STEP_TOL)
        assert (got.logits[~got.valid] == pruning.NEG_INF).all()
    assert np.asarray(want.valid).sum() > 0


def test_reservoir_priorities_match_within_tolerance():
    rng = np.random.RandomState(8)
    n, m, tau = 2000, 10, 86_400.0
    eid = rng.randint(0, 10 ** 6, (n, m)).astype(np.int32)
    vids = rng.randint(0, 10 ** 4, n).astype(np.int32)
    t = (rng.rand(n) * 2e6).astype(np.float32)
    dt = (10 ** rng.uniform(0, 7, (n, m))).astype(np.float32)
    ju = jstages._stateless_uniform(jnp.asarray(eid), jnp.asarray(vids),
                                    jnp.asarray(t))
    want = np.asarray(jnp.log(ju) * jnp.exp(jnp.minimum(dt / tau, 50.0)))
    u = stages._stateless_uniform(_t(eid), _t(vids), _t(t))
    got = (torch.log(u) * torch.exp((_t(dt) / tau).clamp(max=50.0))).numpy()
    np.testing.assert_allclose(got, want, rtol=PRIO_RTOL, atol=0)
    valid = rng.rand(n, m) > 0.2
    for k in (2, 4, 6):
        a = pruning.topk_select(_t(got), _t(valid), k)[0].numpy()
        b = np.asarray(jpruning.topk_select(jnp.asarray(want),
                                            jnp.asarray(valid), k)[0])
        np.testing.assert_array_equal(a, b)


def _port_state_after(g, variant, dims, n_edges, seed=0):
    cfg = tpl.variant_config(variant, **dims)
    pipe = tpl.build_pipeline(cfg, device="cpu")
    params = pipe.init_params(torch.Generator().manual_seed(seed))
    state = pipe.init_state()
    ef = torch.as_tensor(g.edge_feats)
    batches = list(stream.fixed_count(g, 50, window=slice(0, n_edges)))
    for b in batches[:-1]:
        bt = tuple(_t(x) for x in (b.src, b.dst, b.eid, b.ts, b.valid))
        state = tgn.process_batch(params, cfg, state, None, ef, *bt).state
    return params, state, batches[-1]


def _neighborhood(variant, g, params, state, batch, dims):
    pipe = tpl.build_pipeline(variant, device="cpu", **dims)
    vids = torch.cat([_t(batch.src), _t(batch.dst)])
    t = torch.cat([_t(batch.ts), _t(batch.ts)])
    return pipe.stages.sampler(params, pipe.prepare(params), state,
                               torch.as_tensor(g.edge_feats), vids, t)


def _small_dims(g):
    return dict(n_nodes=g.cfg.n_nodes, n_edges=g.n_edges, f_edge=172,
                f_mem=8, f_time=8, f_emb=8, m_r=10)


@pytest.mark.parametrize("variant", ["sat+lut+np4+uniform",
                                     "sat+lut+np4+reservoir"])
def test_randomized_samplers_select_valid_deterministic(variant):
    """The reference's invariant inside the port: k slots, only valid ones
    when enough exist, and two identical queries select identically."""
    g = tgd.wikipedia_like(n_edges=400)
    dims = _small_dims(g)
    params, state, last = _port_state_after(g, variant, dims, 200)
    nb1 = _neighborhood(variant, g, params, state, last, dims)
    nb2 = _neighborhood(variant, g, params, state, last, dims)
    assert torch.equal(nb1.dt, nb2.dt) and torch.equal(nb1.valid, nb2.valid)
    assert nb1.dt.shape[1] == 4
    full = nb1.full_valid.sum(dim=1).numpy()
    sel = nb1.valid.sum(dim=1).numpy()
    assert np.all(sel[full >= 4] == 4)
    assert np.all(sel[full < 4] == full[full < 4])
    assert (full >= 4).any()


def test_reservoir_tau_biases_toward_recency():
    """As tau -> 0 the weight exp(-dt/tau) collapses onto the most recent
    neighbors: the mean selected dt is at most the uniform policy's."""
    g = tgd.wikipedia_like(n_edges=400)
    dims = _small_dims(g)
    params, state, last = _port_state_after(g, "sat+lut+np4", dims, 300)
    nb_u = _neighborhood("sat+lut+np4+uniform", g, params, state, last,
                         dims)
    nb_r = _neighborhood("sat+lut+np4+reservoir", g, params, state, last,
                         dict(dims, reservoir_tau=1e-3))
    du = nb_u.dt[nb_u.valid].numpy()
    dr = nb_r.dt[nb_r.valid].numpy()
    assert len(du) and dr.mean() <= du.mean()


# ---------------------------------------------------------------------------
# registry: names, aliases, grammar, menu
# ---------------------------------------------------------------------------


def test_registry_equals_the_reference():
    assert tpl.VARIANTS == jpl.VARIANTS
    assert tpl.SAMPLER_VARIANTS == jpl.SAMPLER_VARIANTS
    assert stages.SAMPLERS == jstages.SAMPLERS
    assert tpl._ALIASES == jpl._ALIASES
    assert ({k: tuple(v) for k, v in tpl._REGISTRY.items()}
            == {k: tuple(v) for k, v in jpl._REGISTRY.items()})
    assert tpl.spec_menu() == jpl.spec_menu()
    for name in list(jpl._REGISTRY) + list(jpl._ALIASES):
        assert tuple(tpl.resolve_variant(name)) == tuple(
            jpl.resolve_variant(name)), name
        assert tpl.variant_name(name) == jpl.variant_name(name), name


def test_variant_name_round_trip():
    for name in tpl.VARIANTS + tpl.SAMPLER_VARIANTS:
        cfg = tpl.variant_config(name, n_nodes=50, n_edges=50)
        assert tpl.variant_name(cfg) == name
    assert tpl.variant_name(tpl.VariantSpec("sat", "lut", 3)) == "sat+lut+np3"
    assert tpl.resolve_variant("sat+cosine+np3") == tpl.VariantSpec(
        "sat", "cosine", 3)
    assert tpl.resolve_variant("uniform") == tpl.VariantSpec(
        "sat", "lut", 4, "uniform")
    assert tpl.variant_name(tpl.VariantSpec("sat", "lut", 2, "uniform")) == \
        "sat+lut+np2+uniform"
    assert tpl.variant_name(tpl.resolve_variant("reservoir")) == \
        "sat+lut+np4+reservoir"
    assert tpl.resolve_variant("vanilla+cosine+recent").sampler == "recent"
    for dup in ("sat+lut+recent+uniform", "sat+lut+uniform+recent"):
        with pytest.raises(ValueError, match="duplicate sampler"):
            tpl.resolve_variant(dup)


@pytest.mark.parametrize("bad", ["sat+lut+bogus", "nope+cosine", "sat+fft",
                                 "vanilla+cosine+uniform", "vanilla+lut",
                                 "vanilla+cosine+np4", "sat+lut+np4+np2+x"])
def test_invalid_spec_prints_the_full_menu(bad):
    with pytest.raises(ValueError) as ei:
        tpl.build_pipeline(bad, device="cpu", n_nodes=10, n_edges=10)
    msg = str(ei.value)
    for token in ("vanilla", "sat", "cosine", "lut", "np<k>", "recent",
                  "uniform", "reservoir", "registered variants",
                  "aliases"):
        assert token in msg, f"{token!r} missing from menu for {bad!r}"
    with pytest.raises(ValueError):
        jpl.build_pipeline(bad, n_nodes=10, n_edges=10)


def test_engine_and_defaults_follow_the_reference():
    assert tgn.TGNConfig().asdict() == jtgn.TGNConfig().asdict()
    assert (engine.EngineConfig().model.asdict()
            == jengine.EngineConfig().model.asdict())
    g = tgd.wikipedia_like(n_edges=90)
    dims = _small_dims(g)
    for alias in ("teacher", "+SAT", "+NP(S)", "reservoir"):
        params = tpl.build_pipeline(alias, device="cpu",
                                    **dims).init_params()
        eng = StreamingEngine.from_variant(alias, params, g.edge_feats,
                                           use_kernels="fused",
                                           device="cpu", **dims)
        assert eng.describe()["variant"] == jpl.variant_name(alias)
        for _ in eng.run(stream.fixed_count(g, 30)):
            pass
        assert eng.summary()["batches"] == 2


# ---------------------------------------------------------------------------
# the analytic complexity model (Tables I and II)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dataset", sorted(jcx.DATASETS))
def test_complexity_table2_equals_the_reference(dataset):
    assert complexity.table2(dataset) == jcx.table2(dataset)
    assert (complexity.headline_reductions(dataset)
            == jcx.headline_reductions(dataset))
    base = complexity.ComplexityConfig(f_mem=172, m_r=20, lut_entries=64)
    jbase = jcx.ComplexityConfig(f_mem=172, m_r=20, lut_entries=64)
    assert complexity.table2(dataset, base) == jcx.table2(dataset, jbase)
    assert [r[0] for r in complexity.table2(dataset)] == [
        n for n, _ in jcx.VARIANT_LADDER]
