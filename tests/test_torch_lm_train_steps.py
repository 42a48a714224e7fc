"""``make_train_step`` of the port against the reference's jitted step, at
every registered architecture's smoke config (fp32): three-step
trajectories with fp32 AdamW moments (``grad_accum = 2``, int8 moments
and ``compress_grads`` in the files beside this one, with these helpers).

Both packages start from the reference's weights and take steps 1-3
(a one-step warmup, then the cosine) of lr 1e-3 on the same batches of
B x S = 4 x 32. Tolerances: each step's loss rtol 1e-5 and its gradient
norm rtol 1e-5 (fp32 sums in other orders); the parameters after three
steps rtol 1e-4, atol 5e-5, except where the first step's gradient is
rounding noise (|g| <= 1e-5 max|g|: the two packages' gradients differ by
up to 1e-6 max|g|, so its sign is arbitrary; qk-norm makes the key and
query projections' gradients vanish along the scale-invariant
directions). AdamW moves such an entry by lr g / (|g| + eps) a step, any
sign, so there the limit is 2 lr a step.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm_common as jlm
from repro.training import optim as jopt
from repro.training import train_loop as jTL
from repro.training.lr_schedule import ScheduleConfig as jSchedule

from repro_torch import configs, convert, tree
from repro_torch.models import lm_common
from repro_torch.training import optim, train_loop as TL
from repro_torch.training.lr_schedule import ScheduleConfig

torch.set_num_threads(1)

ARCHS = configs.all_archs()
B, S, STEPS, LR = 4, 32, 3, 1e-3
STEP_TOL = dict(rtol=1e-5, atol=0.0)
PARAM_TOL = dict(rtol=1e-4, atol=5e-5)
NOISE = 1e-5


def batches(jcfg) -> list:
    out = []
    fam = jlm.family_of(jcfg)
    for i in range(STEPS):
        rng = np.random.RandomState(100 + i)
        toks = rng.randint(0, jcfg.vocab, (B, S)).astype(np.int32)
        b = {"tokens": toks, "targets": np.roll(toks, -1, 1)}
        if fam == "whisper":
            b["frames"] = rng.randn(B, jcfg.n_frames,
                                    jcfg.d_model).astype(np.float32)
        if fam == "vision_lm":
            b["vision"] = rng.randn(B, jcfg.n_patches,
                                    jcfg.d_model).astype(np.float32)
        out.append(b)
    return out


def train_configs(moments="float32", **kw):
    jt = jTL.TrainConfig(
        optim=jopt.OptimConfig(lr=LR, moment_dtype=moments),
        sched=jSchedule(warmup_steps=1, total_steps=STEPS + 1), **kw)
    tt = TL.TrainConfig(optim=optim.OptimConfig(**jt.optim.asdict()),
                        sched=ScheduleConfig(**jt.sched.asdict()), **kw)
    return jt, tt


@functools.lru_cache(maxsize=None)
def model(arch):
    jcfg = jconfigs.get(arch).smoke_config()
    tcfg = configs.get(arch).smoke_config()
    jp = jlm.init_params(jax.random.key(0), jcfg)
    return jcfg, tcfg, jp


def run_both(arch, moments="float32", **kw):
    """Three steps of each package from the reference's weights: (the
    reference's metrics, params; the port's metrics, params)."""
    jcfg, tcfg, jp = model(arch)
    jt, tt = train_configs(moments, **kw)
    jstep = jax.jit(jTL.make_train_step(
        lambda p, b: jlm.loss_fn(p, jcfg, b), jt))
    tstep = TL.make_train_step(lambda p, b: lm_common.loss_fn(p, tcfg, b),
                               tt)
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    js, ts = jTL.init_train_state(jt, jp), TL.init_train_state(tt, tp)
    jms, tms = [], []
    for i, b in enumerate(batches(jcfg)):
        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, b), i + 1)
        tp, ts, tm = tstep(tp, ts, {k: torch.as_tensor(v)
                                    for k, v in b.items()}, i + 1)
        jms.append(jm)
        tms.append(tm)
    return jms, jp, tms, tp


def noise_mask(arch) -> list:
    """Per leaf, the entries whose first-step gradient (the port's, at the
    reference's weights and the first batch) is rounding noise."""
    jcfg, tcfg, jp = model(arch)
    p = convert.params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    b = {k: torch.as_tensor(v) for k, v in batches(jcfg)[0].items()}
    _, _, g = TL.value_and_grad(
        lambda q, x: (lm_common.loss_fn(q, tcfg, x), None), p, b)
    top = max(float(x.abs().max()) for x in tree.leaves(g))
    return [(x.abs() <= NOISE * top).numpy() for x in tree.leaves(g)]


def check_trajectory(arch, jms, jp, tms, tp):
    for i, (jm, tm) in enumerate(zip(jms, tms)):
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   err_msg=f"loss at step {i + 1}",
                                   **STEP_TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]),
                                   err_msg=f"grad_norm at step {i + 1}",
                                   **STEP_TOL)
        assert float(tm["lr_scale"]) == pytest.approx(float(jm["lr_scale"]),
                                                      rel=1e-6)
    for path, a, b, noise in zip(tree.leaf_paths(tp), tree.leaves(tp),
                                 jax.tree.leaves(jp), noise_mask(arch)):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_allclose(a[~noise], b[~noise], err_msg=path,
                                   **PARAM_TOL)
        assert np.abs(a[noise] - b[noise]).max(initial=0) <= \
            2 * LR * STEPS, path


@pytest.mark.parametrize("arch", ARCHS)
def test_three_steps_match_the_reference(arch):
    check_trajectory(arch, *run_both(arch))


def test_grad_accum_equals_the_mean_of_the_micro_batches():
    """The accumulated step's loss is the mean of the micro-batches'
    losses, and its update the one from their mean gradient."""
    jcfg, tcfg, jp = model("qwen3_8b")
    p = convert.params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    b = {k: torch.as_tensor(v) for k, v in batches(jcfg)[0].items()}
    _, tt = train_configs(grad_accum=2)
    _, _, m = TL.make_train_step(
        lambda q, x: lm_common.loss_fn(q, tcfg, x), tt)(
            p, TL.init_train_state(tt, p), b, 1)
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in b.items()}
              for i in range(2)]
    losses = [lm_common.loss_fn(p, tcfg, h) for h in halves]
    assert float(m["loss"]) == pytest.approx(
        float((losses[0] + losses[1]) / 2), rel=1e-7)
