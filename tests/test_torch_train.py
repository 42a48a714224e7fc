"""Training and distillation in the port, against the JAX package.

The same small stream (24 users, 16 items, 16 edge features, widths 16,
m_r = 10, batches of B = 16, time gaps of a few seconds) goes through
``repro.training`` and ``repro_torch.training``: the Eq.-17 and link
losses and AP, the optimizers and the schedule, the loss and gradients of
one teacher step and one distill step from converted parameters, state and
batch, three-step trajectories of both steps, ``_dt_samples`` and
``evaluate_ap``, and checkpoints written by one package and restored by
the other. The reference's step losses are composed here from its public
functions, as ``tgn_trainer.py`` composes them, under
``jax.value_and_grad``.

Tolerances. Losses are fp32 sums in other orders: rtol 1e-5. Gradients
are held leaf by leaf to rtol 1e-4 plus an atol of 1e-6 times the largest
gradient of the tree: some gradients are zero in exact arithmetic (the
key bias ``attn.b_k``, by the softmax's shift invariance) and are rounding
noise of ~1e-10 on both sides. Stepped parameters: an AdamW step moves a
weight by lr * m / (sqrt(v) + eps); where the gradient is noise of
~1e-10 its sign is arbitrary, and eps = 1e-8 caps that move at about
lr * 1e-2, so after three steps of lr = 1e-3 every weight is held to atol
5e-5 (the step's own rounding is ~1e-7). The optimizers on equal
gradients agree to 1e-6 (one fp32 ulp of the moments a step). Times
stay small here (dt of seconds), so the cosine encoder's gradient
d/domega = -sin(omega dt + phi) dt is well conditioned; nothing is
compared with the reference at real dt.
"""
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distill as jdistill
from repro.core import tgn as jtgn
from repro.core.pipeline import build_pipeline as jbuild
from repro.core.pipeline import variant_config as jvariant
from repro.data import stream as jstream
from repro.data import temporal_graph as jtgd
from repro.distributed import checkpoint as jckpt
from repro.training import lr_schedule as jsched
from repro.training import optim as jopt
from repro.training import tgn_trainer as jtrainer

from repro_torch import convert, tree
from repro_torch.core import distill
from repro_torch.core import pipeline as tpl
from repro_torch.core import tgn
from repro_torch.data import stream, temporal_graph as tgd
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.launch import train as train_cli
from repro_torch.training import lr_schedule, optim
from repro_torch.training import tgn_trainer as trainer

torch.set_num_threads(1)

F = 16                      # widths: f_edge = f_mem = f_time = f_emb
B = 16
N_BATCHES = 12
LR = 1e-3
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_RTOL, GRAD_ATOL_SCALE = 1e-4, 1e-6
PARAM_TOL = dict(rtol=1e-4, atol=5e-5)
OPT_TOL = dict(rtol=1e-6, atol=1e-6)
STATE_TOL = dict(rtol=1e-5, atol=1e-5)
INT_FIELDS = ("mail_valid", "nbr_ids", "nbr_eid", "nbr_cursor")
STUDENTS = ("sat+cosine", "sat+lut+np4", "sat+lut+np2")


def _graph(mod):
    return mod.generate(mod.StreamConfig(
        n_users=24, n_items=16, n_edges=N_BATCHES * B, f_edge=F,
        t_scale=1.0, seed=0))


DIMS = dict(n_nodes=40, n_edges=N_BATCHES * B, f_edge=F, f_mem=F, f_time=F,
            f_emb=F, m_r=10)


@pytest.fixture(scope="module")
def data():
    jg, g = _graph(jtgd), _graph(tgd)
    batches = list(jstream.fixed_count(jg, B, seed=0))
    node_feats, edge_feats = trainer.features(g, tgn.TGNConfig(**DIMS),
                                              "cpu")
    return dict(jg=jg, g=g, batches=batches, jef=jnp.asarray(jg.edge_feats),
                ef=edge_feats, nf=node_feats)


def _np(t):
    return jax.tree.map(np.asarray, t)


def _jb(b):
    return tuple(jnp.asarray(x) for x in b)


def _jax_params(variant, seed, dt_samples=None):
    jcfg = jvariant(variant, **DIMS)
    p = jtgn.init_params(jax.random.key(seed), jcfg, dt_samples=dt_samples)
    return jcfg, p, convert.params_from_reference(_np(p), "cpu")


def _check_grads(got, want, where):
    assert tree.leaf_paths(got) == jckpt._leaf_paths(want)
    want = jax.tree.leaves(want)
    atol = GRAD_ATOL_SCALE * max(float(jnp.abs(w).max()) for w in want)
    for path, g, w in zip(tree.leaf_paths(got), tree.leaves(got), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=atol, err_msg=f"{where}: {path}")


def _check_state(got, want, where):
    for f in got._fields:
        a, b = getattr(got, f).detach().numpy(), np.asarray(getattr(want, f))
        if f in INT_FIELDS:
            np.testing.assert_array_equal(a, b, err_msg=f"{where}: {f}")
        else:
            np.testing.assert_allclose(a, b, err_msg=f"{where}: {f}",
                                       **STATE_TOL)


# ---------------------------------------------------------------------------
# losses and AP (mirrors tests/test_distill_and_serving.py)
# ---------------------------------------------------------------------------


def _logit_case(seed, rows=6, m_r=10):
    rng = np.random.RandomState(seed)
    s = rng.randn(rows, m_r).astype(np.float32) * 3
    t = rng.randn(rows, m_r).astype(np.float32) * 3
    valid = rng.rand(rows, m_r) > 0.4
    valid[0] = False                           # a row with no neighbour
    valid[1] = True
    return s, t, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("temperature", [1.0, 2.0])
def test_kd_loss_and_its_gradient_match_reference(seed, temperature):
    s, t, valid = _logit_case(seed)
    want, want_g = jax.value_and_grad(
        lambda x: jdistill.attn_distill_loss(x, jnp.asarray(t),
                                             jnp.asarray(valid),
                                             temperature))(jnp.asarray(s))
    st = torch.tensor(s, requires_grad=True)
    got = distill.attn_distill_loss(st, torch.tensor(t), torch.tensor(valid),
                                    temperature)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **LOSS_TOL)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        distill.masked_log_softmax(torch.tensor(s), torch.tensor(valid))
        .numpy()[valid],
        np.asarray(jdistill.masked_log_softmax(jnp.asarray(s),
                                               jnp.asarray(valid)))[valid],
        rtol=1e-5, atol=1e-5)


def test_kd_loss_gradient_is_zero_when_matched_and_masks_invalid():
    logits = torch.tensor([[1.0, 2.0, 3.0], [0.0, -1.0, 2.0]],
                          requires_grad=True)
    valid = torch.ones((2, 3), dtype=torch.bool)
    same = distill.attn_distill_loss(logits, logits.detach(), valid)
    same.backward()
    np.testing.assert_allclose(logits.grad.numpy(), 0.0, atol=1e-6)
    off = distill.attn_distill_loss(
        logits.detach() + torch.tensor([[1.0, 0.0, -1.0]]), logits.detach(),
        valid)
    assert float(off) > float(same.detach())
    s, t, valid = (torch.tensor(x) for x in _logit_case(5))
    noise = torch.where(valid, torch.zeros_like(s), 100.0 * torch.randn(
        s.shape, generator=torch.Generator().manual_seed(0)))
    np.testing.assert_allclose(
        float(distill.attn_distill_loss(s + noise, t + noise, valid)),
        float(distill.attn_distill_loss(s, t, valid)), rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 3])
def test_link_and_total_losses_match_reference(seed):
    rng = np.random.RandomState(seed)
    s, t, valid = _logit_case(seed)
    pos, neg = (rng.randn(12).astype(np.float32) * 4 for _ in range(2))
    want_total, want = jdistill.distill_loss(
        *(jnp.asarray(x) for x in (s, t, valid, pos, neg)), temperature=1.5,
        kd_weight=0.7)
    got_total, got = distill.distill_loss(
        *(torch.tensor(x) for x in (s, t, valid, pos, neg)), temperature=1.5,
        kd_weight=0.7)
    for k in ("link", "kd", "total"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   err_msg=k, **LOSS_TOL)
    np.testing.assert_allclose(float(got_total), float(want_total),
                               **LOSS_TOL)


def test_average_precision_perfect_inverted_and_tied():
    pos, neg = [3.0, 2.5, 2.0], [-1.0, -2.0, 0.0]
    for a, b in ((pos, neg), (neg, pos), ([1.0, 1.0, 0.0], [1.0, 0.0, 0.0])):
        got = float(distill.average_precision(torch.tensor(a),
                                              torch.tensor(b)))
        want = float(jdistill.average_precision(jnp.asarray(a),
                                                jnp.asarray(b)))
        assert got == want, (a, b, got, want)
    assert float(distill.average_precision(torch.tensor(pos),
                                           torch.tensor(neg))) == 1.0


@pytest.mark.parametrize("seed", [0, 1])
def test_average_precision_matches_reference_with_many_ties(seed):
    """Scores rounded to a coarse grid tie often: the stable sort must
    order ties as ``jnp.argsort`` does."""
    rng = np.random.RandomState(seed)
    pos = np.round(rng.randn(300), 1).astype(np.float32)
    neg = np.round(rng.randn(300) - 0.5, 1).astype(np.float32)
    got = float(distill.average_precision(torch.tensor(pos),
                                          torch.tensor(neg)))
    want = float(jdistill.average_precision(jnp.asarray(pos),
                                            jnp.asarray(neg)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# optimizers and schedule (mirrors tests/test_optim.py)
# ---------------------------------------------------------------------------


def _opt_params(rng):
    return {"a": {"w": rng.randn(6, 300).astype(np.float32),
                  "b": rng.randn(7).astype(np.float32)},
            "c": rng.randn(3, 3).astype(np.float32)}


@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("name", ["adamw", "lion", "sgd"])
def test_optimizer_matches_reference_over_five_steps(name, moments):
    rng = np.random.RandomState(0)
    p0 = _opt_params(rng)
    jcfg = jopt.OptimConfig(name=name, moment_dtype=moments, lr=1e-2,
                            weight_decay=0.05)
    cfg = optim.OptimConfig(**jcfg.asdict())
    jp, p = jax.tree.map(jnp.asarray, p0), tree.map(torch.tensor, p0)
    js, s = jopt.init_state(jcfg, jp), optim.init_state(cfg, p)
    for _ in range(5):
        g = jax.tree.map(lambda x: (rng.randn(*x.shape) * 3).astype(
            np.float32), p0)
        js, jp = jopt.apply_updates(jcfg, js, jax.tree.map(jnp.asarray, g),
                                    jp, lr_scale=0.5)
        s, p = optim.apply_updates(cfg, s, tree.map(torch.tensor, g), p,
                                   lr_scale=0.5)
    for path, a, b in zip(tree.leaf_paths(p), tree.leaves(p),
                          jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=path,
                                   **OPT_TOL)
    got_s = convert.opt_state_to_numpy(s)
    assert tree.leaf_paths(got_s) == jckpt._leaf_paths(_np(js))
    for path, a, b in zip(tree.leaf_paths(got_s), tree.leaves(got_s),
                          jax.tree.leaves(js)):
        b = np.asarray(b)
        if b.dtype == np.int8:     # a quantized moment: one step of 1
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, path
        else:
            np.testing.assert_allclose(a, b.astype(np.float32),
                                       err_msg=path, rtol=1e-2 if
                                       moments == "bfloat16" else 1e-5,
                                       atol=1e-6)


def test_global_clip_and_lion_sign_update_match_reference():
    g = {"a": torch.ones(10) * 3.0, "b": torch.full((2, 2), -1.0)}
    clipped, gn = optim.clip_by_global_norm(g, 1.0)
    jclipped, jgn = jopt.clip_by_global_norm(tree.map(
        lambda x: jnp.asarray(x.numpy()), g), 1.0)
    np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
    np.testing.assert_allclose(float(optim.global_norm(clipped)), 1.0,
                               rtol=1e-5)
    for a, b in zip(tree.leaves(clipped), jax.tree.leaves(jclipped)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    small, gn_small = optim.clip_by_global_norm({"a": torch.full((4,), 0.1)},
                                                1.0)
    assert torch.equal(small["a"], torch.full((4,), 0.1))   # scale exactly 1
    cfg = optim.OptimConfig(name="lion", lr=1e-2, b1=0.9, b2=0.99,
                            weight_decay=0.0, global_clip=0)
    params = {"w": torch.zeros((3, 3))}
    grads = {"w": torch.tensor([[1.0, -2.0, 0.5]] * 3)}
    _, params = optim.apply_updates(cfg, optim.init_state(cfg, params),
                                    grads, params)
    np.testing.assert_allclose(params["w"].numpy(),
                               -1e-2 * np.sign(grads["w"].numpy()))


def test_weight_decay_only_on_matrices_and_zero_gradients_leave_weights():
    """AdamW decays leaves with ndim >= 2 only, and a zero gradient on an
    undecayed leaf leaves it bit-identical (the LUT boundaries)."""
    cfg = optim.OptimConfig(name="adamw", lr=1e-2, weight_decay=0.1,
                            global_clip=1.0)
    params = {"m": torch.ones((2, 2)), "bounds": torch.linspace(0, 5, 7)}
    grads = tree.map(torch.zeros_like, params)
    state = optim.init_state(cfg, params)
    p = params
    for _ in range(3):
        state, p = optim.apply_updates(cfg, state, grads, p)
    assert torch.equal(p["bounds"], params["bounds"])
    assert (p["m"] < 1.0).all()
    assert int(state["step"]) == 3


@pytest.mark.parametrize("seed", [0, 7])
def test_int8_moment_round_trip_matches_reference(seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(37, 13) * 10 ** rng.uniform(-3, 3)).astype(np.float32)
    q = optim._quantize(torch.tensor(x))
    jq = jopt._quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.q.numpy(), np.asarray(jq.q))
    np.testing.assert_allclose(q.scale.numpy(), np.asarray(jq.scale),
                               rtol=1e-7)
    back = optim._dequantize(q, x.shape).numpy()
    assert np.abs(back - x).max() <= np.abs(x).max() / 254 * 1.0001 + 1e-12


@pytest.mark.parametrize("name", ["warmup_cosine", "warmup_linear",
                                  "constant"])
def test_schedule_matches_reference(name):
    jcfg = jsched.ScheduleConfig(name=name, warmup_steps=10,
                                 total_steps=100, min_ratio=0.1)
    cfg = lr_schedule.ScheduleConfig(**jcfg.asdict())
    for step in (0, 1, 5, 10, 11, 55, 99, 100, 150):
        np.testing.assert_allclose(
            float(lr_schedule.schedule(cfg, step)),
            float(jsched.schedule(jcfg, step)), rtol=1e-6, atol=1e-7,
            err_msg=f"step {step}")
    assert float(lr_schedule.schedule(cfg, torch.tensor(10))) == 1.0 or \
        name != "constant"


# ---------------------------------------------------------------------------
# one step's loss and gradients, from converted params, state and batch
# ---------------------------------------------------------------------------


def _jax_teacher_vg(jcfg, ef):
    """The reference teacher loss, as tgn_trainer.make_teacher_step
    composes it."""
    pipe = jbuild(jcfg)

    def loss_fn(params, state, b):
        src, dst, eid, ts, valid, neg = b
        aux = pipe.prepare(params)
        out = pipe.step(params, aux, state, (src, dst, eid, ts, valid), ef,
                        None)
        neg_emb, _, _, _ = pipe.embed(params, aux, out.state, ef, None, neg,
                                      ts)
        pos = jtgn.link_score(params, out.emb_src, out.emb_dst)
        negs = jtgn.link_score(params, out.emb_src, neg_emb)
        w = valid.astype(jnp.float32)
        loss = (jnp.sum(jax.nn.softplus(-pos) * w)
                + jnp.sum(jax.nn.softplus(negs) * w)) / (
                    2 * jnp.maximum(jnp.sum(w), 1))
        return loss, out.state

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _jax_distill_vg(js_cfg, jt_cfg, tcfg, ef):
    """The reference student loss, as tgn_trainer.make_distill_step
    composes it."""
    t_pipe, s_pipe = jbuild(jt_cfg), jbuild(js_cfg)

    def loss_fn(s_params, t_params, s_state, t_state, b):
        src, dst, eid, ts, valid, neg = b
        batch = (src, dst, eid, ts, valid)
        t_out = t_pipe.step(t_params, t_pipe.prepare(t_params), t_state,
                            batch, ef, None)
        s_aux = s_pipe.prepare(s_params)
        s_out = s_pipe.step(s_params, s_aux, s_state, batch, ef, None)
        neg_emb, _, _, _ = s_pipe.embed(s_params, s_aux, s_out.state, ef,
                                        None, neg, ts)
        pos = jtgn.link_score(s_params, s_out.emb_src, s_out.emb_dst)
        negs = jtgn.link_score(s_params, s_out.emb_src, neg_emb)
        total, parts = jdistill.distill_loss(
            s_out.attn_logits, t_out.attn_logits,
            s_out.nbr_valid & t_out.nbr_valid, pos, negs,
            temperature=tcfg.kd_temperature, kd_weight=tcfg.kd_weight)
        return total, (s_out.state, t_out.state, parts)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def test_teacher_step_loss_and_gradients_match_reference(data):
    """At each of four batches, from the reference's state converted: the
    loss, the new state and every parameter's gradient (the cosine omega
    and phi included)."""
    jcfg, jp, p = _jax_params("teacher", 0)
    cfg = tpl.variant_config("teacher", **DIMS)
    vg = _jax_teacher_vg(jcfg, data["jef"])
    loss_fn = trainer.make_teacher_loss(cfg, data["nf"], data["ef"])
    jstate = jtgn.init_state(jcfg)
    for i, b in enumerate(data["batches"][:4]):
        state = convert.state_from_reference(_np(jstate), "cpu")
        (jl, jnew), jg = vg(jp, jstate, _jb(b))
        loss, new, grads = trainer.value_and_grad(
            loss_fn, p, state, trainer.batch_tensors(b, "cpu"))
        np.testing.assert_allclose(float(loss), float(jl), **LOSS_TOL)
        _check_state(new, jnew, f"batch {i}")
        _check_grads(grads, jg, f"batch {i}")
        assert float(grads["time"]["omega"].abs().max()) > 0
        jstate = jnew


@pytest.mark.parametrize("student", STUDENTS)
def test_distill_step_loss_parts_and_gradients_match_reference(data,
                                                               student):
    """From a state three batches in (so the KD term sees neighbours): the
    total, link and KD losses, both new states and the student's
    gradients; the LUT boundaries get zero gradients."""
    tcfg = jtrainer.TGNTrainConfig(batch_size=B, kd_temperature=1.5)
    jt_cfg, jtp, tp = _jax_params("teacher", 0)
    dts = jtrainer._dt_samples(data["jg"], slice(0, 8 * B))
    js_cfg, jsp, sp = _jax_params(student, 7, dt_samples=dts)
    vg = _jax_distill_vg(js_cfg, jt_cfg, tcfg, data["jef"])
    loss_fn = trainer.make_distill_loss(
        tpl.variant_config(student, **DIMS),
        tpl.variant_config("teacher", **DIMS),
        trainer.TGNTrainConfig(**tcfg.asdict()), data["nf"], data["ef"])
    jss, jts = jtgn.init_state(js_cfg), jtgn.init_state(jt_cfg)
    for i, b in enumerate(data["batches"][:4]):
        (jl, (jsn, jtn, jparts)), jg = vg(jsp, jtp, jss, jts, _jb(b))
        if i == 3:
            ss, ts = (convert.state_from_reference(_np(x), "cpu")
                      for x in (jss, jts))
            loss, (sn, tn, parts), grads = trainer.value_and_grad(
                loss_fn, sp, tp, ss, ts, trainer.batch_tensors(b, "cpu"))
            np.testing.assert_allclose(float(loss), float(jl), **LOSS_TOL)
            assert float(parts["kd"]) > 0
            for k in ("link", "kd", "total"):
                np.testing.assert_allclose(float(parts[k]),
                                           float(jparts[k]), err_msg=k,
                                           **LOSS_TOL)
            _check_state(sn, jsn, "student state")
            _check_state(tn, jtn, "teacher state")
            _check_grads(grads, jg, student)
            if "boundaries" in grads["time"]:
                assert not grads["time"]["boundaries"].any()
        jss, jts = jsn, jtn


# ---------------------------------------------------------------------------
# three-step trajectories of the trainer's steps
# ---------------------------------------------------------------------------


def _ocfgs():
    jcfg = jopt.OptimConfig(name="adamw", lr=LR, weight_decay=0.0)
    return jcfg, optim.OptimConfig(**jcfg.asdict())


def _check_params(got, want, where):
    for path, a, b in zip(tree.leaf_paths(got), tree.leaves(got),
                          jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   err_msg=f"{where}: {path}", **PARAM_TOL)


def test_teacher_trajectory_of_three_steps_matches_reference(data):
    jcfg, jp, p = _jax_params("teacher", 0)
    jocfg, ocfg = _ocfgs()
    jstep = jtrainer.make_teacher_step(jcfg, jocfg, None, data["jef"])
    step = trainer.make_teacher_step(tpl.variant_config("teacher", **DIMS),
                                     ocfg, data["nf"], data["ef"])
    jos, os_ = jopt.init_state(jocfg, jp), optim.init_state(ocfg, p)
    js, s = jtgn.init_state(jcfg), tgn.init_state(
        tpl.variant_config("teacher", **DIMS), "cpu")
    for i, b in enumerate(data["batches"][:3]):
        jp, jos, js, jl = jstep(jp, jos, js, _jb(b))
        p, os_, s, loss = step(p, os_, s, trainer.batch_tensors(b, "cpu"))
        np.testing.assert_allclose(float(loss), float(jl), **LOSS_TOL)
        assert s.memory.grad_fn is None and not s.memory.requires_grad
    assert int(os_["step"]) == 3
    _check_params(p, jp, "teacher after 3 steps")
    _check_state(s, js, "teacher state after 3 steps")


def test_distill_trajectory_of_three_steps_matches_reference(data):
    tcfg = jtrainer.TGNTrainConfig(batch_size=B)
    jt_cfg, jtp, tp = _jax_params("teacher", 0)
    dts = jtrainer._dt_samples(data["jg"], slice(0, 8 * B))
    js_cfg, jsp, sp = _jax_params("sat+lut+np4", 7, dt_samples=dts)
    bounds0 = sp["time"]["boundaries"].clone()
    jocfg, ocfg = _ocfgs()
    jstep = jtrainer.make_distill_step(js_cfg, jt_cfg, jocfg, tcfg, None,
                                       data["jef"])
    s_cfg = tpl.variant_config("sat+lut+np4", **DIMS)
    t_cfg = tpl.variant_config("teacher", **DIMS)
    step = trainer.make_distill_step(s_cfg, t_cfg, ocfg,
                                     trainer.TGNTrainConfig(**tcfg.asdict()),
                                     data["nf"], data["ef"])
    jos, os_ = jopt.init_state(jocfg, jsp), optim.init_state(ocfg, sp)
    jss, jts = jtgn.init_state(js_cfg), jtgn.init_state(jt_cfg)
    ss, ts = tgn.init_state(s_cfg, "cpu"), tgn.init_state(t_cfg, "cpu")
    tp0 = tree.map(torch.clone, tp)
    for i, b in enumerate(data["batches"][:3]):
        jsp, jos, jss, jts, jparts = jstep(jsp, jtp, jos, jss, jts, _jb(b))
        sp, os_, ss, ts, parts = step(sp, tp, os_, ss, ts,
                                      trainer.batch_tensors(b, "cpu"))
        for k in ("link", "kd", "total"):
            np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                       err_msg=f"step {i} {k}", **LOSS_TOL)
    _check_params(sp, jsp, "student after 3 steps")
    _check_state(ss, jss, "student state after 3 steps")
    _check_state(ts, jts, "teacher state after 3 steps")
    assert torch.equal(sp["time"]["boundaries"], bounds0)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(tp),
                                                 tree.leaves(tp0)))


# ---------------------------------------------------------------------------
# autograd through the vertex state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["teacher", "sat+lut+np4"])
def test_step_graph_reads_no_state_table_and_writes_none_in_place(data,
                                                                  variant):
    """A training step keeps the vertex state functional: the forward and
    backward change no table of the input state (values and version
    counters), the new state shares no storage with it, and the graph
    saves no tensor that aliases a table of either state, so an in-place
    commit into the tables (serving's way) could not change this step's
    gradients. Writing into the new state's tables between forward and
    backward leaves the gradients bit for bit."""
    cfg = tpl.variant_config(variant, **DIMS)
    p = tgn.init_params(torch.Generator().manual_seed(1), cfg, "cpu")
    pipe = tpl.build_pipeline(cfg, device="cpu")
    state = pipe.init_state()
    with torch.no_grad():
        for b in data["batches"][:3]:
            state = pipe.step_fn(p, state, trainer.batch_tensors(
                b, "cpu")[:5], data["ef"]).state
    b = trainer.batch_tensors(data["batches"][3], "cpu")
    loss_fn = trainer.make_teacher_loss(cfg, data["nf"], data["ef"])
    before = [t.clone() for t in state]
    versions = [t._version for t in state]
    saved = []

    def pack(t):
        saved.append(t)
        return t

    live = [x.detach().requires_grad_(True) for x in tree.leaves(p)]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, new = loss_fn(tree.unflatten(p, live), state, b)
    grads = torch.autograd.grad(loss, live, allow_unused=True,
                                retain_graph=True)
    assert all(torch.equal(a, c) for a, c in zip(state, before))
    assert [t._version for t in state] == versions
    tables = {t.untyped_storage().data_ptr() for t in (*state, *new)}
    assert not {t.untyped_storage().data_ptr() for t in state} & {
        t.untyped_storage().data_ptr() for t in new}
    assert saved and not any(
        t.untyped_storage().data_ptr() in tables for t in saved)
    with torch.no_grad():
        for t in new:
            if t.dtype.is_floating_point:
                t.add_(1.0)
    again = torch.autograd.grad(loss, live, allow_unused=True)
    for g1, g2 in zip(grads, again):
        assert (g1 is None and g2 is None) or torch.equal(g1, g2)


# ---------------------------------------------------------------------------
# LUT samples, evaluation, entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [slice(0, 8 * B), slice(5, 101),
                                    slice(0, 1)])
def test_dt_samples_are_array_equal(data, window):
    got = trainer._dt_samples(data["g"], window)
    want = jtrainer._dt_samples(data["jg"], window)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant", ["teacher", "sat+lut+np4"])
def test_evaluate_ap_matches_reference(data, variant):
    dts = jtrainer._dt_samples(data["jg"], slice(0, 8 * B))
    jcfg, jp, p = _jax_params(variant, 3, dt_samples=dts)
    tr, va, te = jstream.chronological_split(data["jg"])
    assert (tr, va, te) == stream.chronological_split(data["g"])
    want = jtrainer.evaluate_ap(jp, jcfg, data["jg"], te, batch_size=B,
                                warm_window=slice(0, va.stop))
    got = trainer.evaluate_ap(p, tpl.variant_config(variant, **DIMS),
                              data["g"], te, batch_size=B,
                              warm_window=slice(0, va.stop), device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_trainer_entry_points_run_on_cpu_and_refuse_without_cuda(
        data, monkeypatch, capsys, tmp_path):
    g = data["g"]
    tcfg = trainer.TGNTrainConfig(batch_size=B, epochs=1)
    t_cfg = tpl.variant_config("teacher", **DIMS)
    s_cfg = tpl.variant_config("sat+lut+np4", **DIMS)
    train_sl, _, _ = stream.chronological_split(g)
    n_steps = -(-train_sl.stop // B)
    tp, losses = trainer.train_teacher(g, t_cfg, tcfg, device="cpu")
    assert len(losses) == n_steps and np.isfinite(losses).all()
    sp, parts = trainer.distill_student(g, tp, t_cfg, s_cfg, tcfg,
                                        device="cpu")
    assert len(parts) == n_steps
    assert set(parts[0]) == {"link", "kd", "total"}
    assert all(np.isfinite(list(q.values())).all() for q in parts)
    # the student's bounds are fitted on the train window's deltas
    want = tgn.init_params(torch.Generator().manual_seed(7), s_cfg, "cpu",
                           dt_samples=trainer._dt_samples(g, train_sl))
    assert torch.equal(sp["time"]["boundaries"],
                       want["time"]["boundaries"])
    train_cli.main(["--edges", "300", "--f-mem", "8", "--epochs", "1",
                    "--batch", "50", "--device", "cpu", "--ckpt",
                    str(tmp_path)])
    out = capsys.readouterr().out
    for name in ("teacher", "+SAT", "+LUT", "+NP(L)", "+NP(M)", "+NP(S)"):
        assert f"[{name}] AP=" in out
    assert ckpt.latest_step(str(tmp_path / "student_+NP(M)")) == 0
    # --mode lm is ported: it trains on the CPU when asked to
    lm = train_cli.main(["--mode", "lm", "--steps", "1", "--batch", "2",
                         "--seq", "16", "--device", "cpu"])
    assert len(lm["losses"]) == 1 and np.isfinite(lm["losses"]).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: trainer.train_teacher(g, t_cfg, tcfg),
                 lambda: trainer.distill_student(g, tp, t_cfg, s_cfg, tcfg),
                 lambda: trainer.evaluate_ap(tp, t_cfg, g, slice(0, B)),
                 lambda: ckpt.restore(str(tmp_path / "teacher"), tp),
                 lambda: train_cli.main(["--edges", "300"]),
                 lambda: train_cli.main(["--mode", "lm", "--steps", "1"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# ---------------------------------------------------------------------------
# checkpoints across packages
# ---------------------------------------------------------------------------


def _train_trees(moments):
    """A student's params and an optimizer state one step in, as the
    reference's tree and the port's."""
    rng = np.random.RandomState(2)
    _, jp, p = _jax_params("sat+lut+np4", 7)
    jocfg = jopt.OptimConfig(moment_dtype=moments)
    g = jax.tree.map(lambda x: jnp.asarray(rng.randn(*x.shape).astype(
        np.float32)), jp)
    jos, jp = jopt.apply_updates(jocfg, jopt.init_state(jocfg, jp), g, jp)
    jtree = {"params": jp, "opt": jos}
    ttree = {"params": convert.params_from_reference(_np(jp), "cpu"),
             "opt": convert.opt_state_from_reference(_np(jos), "cpu")}
    return jtree, ttree


def _equal_trees(got, want):
    for a, b in zip(tree.leaves(got), jax.tree.leaves(want)):
        b = np.asarray(b)
        a = a.float() if a.dtype == torch.bfloat16 else a
        np.testing.assert_array_equal(np.asarray(a), b.astype(
            np.float32) if b.dtype.name == "bfloat16" else b)


@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
def test_checkpoint_written_by_either_package_restores_in_the_other(
        tmp_path, moments):
    jtree, ttree = _train_trees(moments)
    assert tree.leaf_paths(ttree) == jckpt._leaf_paths(jtree)
    assert ckpt.tree_digest(ttree) == jckpt.tree_digest(jtree)
    jckpt.save(str(tmp_path / "jax"), 5, jtree, meta={"by": "reference"})
    ckpt.save(str(tmp_path / "port"), 5, ttree, meta={"by": "reference"})
    # the same bytes on disk: manifest and every array file
    jdir, tdir = tmp_path / "jax" / "step_00000005", \
        tmp_path / "port" / "step_00000005"
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    for name in os.listdir(jdir):
        assert (jdir / name).read_bytes() == (tdir / name).read_bytes(), name
    got, meta = ckpt.restore(str(tmp_path / "jax"), ttree, device="cpu")
    assert meta == {"by": "reference"}
    _equal_trees(got, jtree)
    assert ckpt.tree_digest(got) == jckpt.tree_digest(jtree)
    back, _ = jckpt.restore(str(tmp_path / "port"), jtree)
    _equal_trees(ttree, back)
    assert jckpt.tree_digest(back) == ckpt.tree_digest(ttree)


def test_opt_state_continues_a_reference_run_in_the_port():
    """A reference run's params and AdamW state, converted, take the next
    step in the port as the reference takes it."""
    jtree, ttree = _train_trees("float32")
    jocfg = jopt.OptimConfig()
    rng = np.random.RandomState(9)
    g = jax.tree.map(lambda x: rng.randn(*x.shape).astype(np.float32),
                     _np(jtree["params"]))
    jos, jp = jopt.apply_updates(jocfg, jtree["opt"], jax.tree.map(
        jnp.asarray, g), jtree["params"])
    os_, p = optim.apply_updates(optim.OptimConfig(**jocfg.asdict()),
                                 ttree["opt"], tree.map(torch.tensor, g),
                                 ttree["params"])
    assert int(os_["step"]) == int(jos["step"]) == 2
    for a, b in zip(tree.leaves(p), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **OPT_TOL)
    back = convert.opt_state_to_numpy(os_)
    for a, b in zip(tree.leaves(back), jax.tree.leaves(jos)):
        np.testing.assert_allclose(a, np.asarray(b), **OPT_TOL)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_corrupt_latest_step_falls_back_in_both_packages(tmp_path, writer):
    jtree, ttree = _train_trees("float32")
    root = str(tmp_path)
    for step in (1, 2):
        if writer == "port":
            ckpt.save(root, step, ttree, meta={"step": step})
        else:
            jckpt.save(root, step, jtree, meta={"step": step})
    f = tmp_path / "step_00000002" / "arr_00003.npy"
    raw = bytearray(f.read_bytes())
    raw[-1] ^= 0xFF
    f.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="checksum"):
        ckpt.restore(root, ttree, device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got, meta, step = ckpt.restore_valid(root, ttree, device="cpu")
        _, jmeta, jstep = jckpt.restore_valid(root, jtree)
    assert step == jstep == 1 and meta == jmeta == {"step": 1}
    assert sum("corrupt" in str(w.message) for w in caught) == 2
    _equal_trees(got, jtree)
    (tmp_path / "step_00000001" / "manifest.json").write_text("{")
    with pytest.raises(IOError):
        ckpt.restore_valid(root, ttree, device="cpu")


def test_async_checkpointer_gc_and_tmp_dirs(tmp_path):
    _, ttree = _train_trees("int8")
    root = str(tmp_path)
    os.makedirs(tmp_path / "step_00000009.tmp")       # a crashed write
    saver = ckpt.AsyncCheckpointer(root, keep=2)
    for step in (1, 2, 3):
        saver.save(step, ttree, meta={"step": step})
    saver.wait()
    assert ckpt.list_steps(root) == [2, 3]
    assert not any(d.endswith(".tmp") for d in os.listdir(root))
    got, meta = ckpt.restore(root, ttree, device="cpu")
    assert meta == {"step": 3}
    assert ckpt.tree_digest(got) == ckpt.tree_digest(ttree)
    assert isinstance(got["opt"]["m"]["gru"]["w_i"], optim.QTensor)
    ckpt.save(root, 1, ttree, keep=2, floor=1)        # a lagging writer
    assert ckpt.list_steps(root) == [1, 2, 3]
