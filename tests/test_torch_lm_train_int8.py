"""``make_train_step`` with int8 AdamW moments, and with int8
error-feedback gradient compression, against the reference's jitted step
at every registered architecture's smoke config: three steps, each taken
from the reference's own state (its parameters, int8 moments and EF
residual converted), with the helpers of ``test_torch_lm_train_steps.py``.

A free trajectory cannot stay close here. The packages' gradients differ
by up to 1e-4 relative (plus 1e-6 of the largest), and an entry that close
to a rounding boundary of an int8 payload rounds the other way in one of
them; where v's payload then holds 0, the next step divides m by little
more than eps and moves that weight by O(1). So each step is held on its
own: its loss (rtol 1e-5); the port's gradients, at the step's weights,
within delta of the reference's; every moment payload within one step of
the reference's, payloads that differ (or EF residuals a quantum apart)
on at most 0.1% of the entries, and each block's scale within rtol 1e-4;
the parameters within 1e-4 (|p| + lr) plus how far the step's parameters
move when its gradients move within delta (``step_spread``). delta is
|d| <= 1e-4 |g| + a max|g| (g the port's gradient, max over the tree),
and, compressed, one quantum of the entry's block on top. At step 1 a is
the initial weights' limit of ``test_torch_lm_train.py`` (1e-6, 1e-5 for
the RG-LRU hybrid); at steps 2 and 3, where the int8 steps have moved
weights by O(1), a is 1e-5 for every architecture: the largest reading
there is |d| = 4.85e-6 max|g| (the RG-LRU hybrid's embedding at step 2;
2.96e-6 for every other architecture), against 1e-6 on most of them
at step 1.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm_common as jlm
from repro.training import train_loop as jTL

from repro_torch import configs, convert, tree
from repro_torch.distributed import compression
from repro_torch.models import lm_common
from repro_torch.training import optim, train_loop as TL
from repro_torch.training.lr_schedule import schedule

from test_torch_lm_train import ATOL_SCALE_OF, GRAD_ATOL_SCALE, GRAD_RTOL
from test_torch_lm_train_steps import LR, batches, model, train_configs

torch.set_num_threads(1)

FLIP_SHARE = 1e-3
#: the gradient limit's atol, a fraction of max|g|, at steps 2 and 3
LATER_ATOL_SCALE = 1e-5


def _np(t):
    return jax.tree.map(np.asarray, t)


def payloads(state, key) -> list:
    """The int8 payloads of moment ``key``: one (q, scale) a leaf."""
    return [(np.asarray(q.q), np.asarray(q.scale)) for q in tree.leaves(
        state[key], is_leaf=lambda x: hasattr(x, "_fields"))]


def quantum(x: torch.Tensor) -> torch.Tensor:
    """Each entry's int8 quantum: its 256-block's max |x| / 127."""
    blocks = compression._blocks(x)
    q = (blocks.abs().amax(dim=1, keepdim=True) / 127.0).expand_as(blocks)
    return q.reshape(-1)[:x.numel()].reshape(x.shape)


def step_spread(tt, state, grads, params, step, delta):
    """How far one optimizer step's parameters move while its gradients
    move within ``delta`` of ``grads``: the range of the step taken from
    g - delta, g, g + delta and, where |g| <= delta, g = 0. AdamW's move
    m / (sqrt(v) + eps) is monotone in an entry's gradient on each side of
    0 and peaks near 0 (v is smallest there), so the range holds every
    gradient in the interval."""
    inner = {k: v for k, v in state.items() if k != "ef_residual"}
    lr_scale = schedule(tt.sched, step)
    points = [tree.map(torch.sub, grads, delta), grads,
              tree.map(torch.add, grads, delta),
              tree.map(lambda g, d: torch.where(g.abs() <= d, 0.0, g),
                       grads, delta)]
    outs = [tree.leaves(optim.apply_updates(tt.optim, inner, g, params,
                                            lr_scale)[1]) for g in points]
    return [(torch.stack(ps).amax(0) - torch.stack(ps).amin(0)).numpy()
            for ps in zip(*outs)]


@functools.lru_cache(maxsize=None)
def ref_grad_fn(arch):
    jcfg = model(arch)[0]
    return jax.jit(jax.grad(lambda p, b: jlm.loss_fn(p, jcfg, b)))


def run_forced(arch, moments="float32", **kw):
    jcfg, tcfg, jp = model(arch)
    jt, tt = train_configs(moments, **kw)
    jstep = jax.jit(jTL.make_train_step(
        lambda p, b: jlm.loss_fn(p, jcfg, b), jt))
    tstep = TL.make_train_step(lambda p, b: lm_common.loss_fn(p, tcfg, b),
                               tt)
    js = jTL.init_train_state(jt, jp)
    for i, b in enumerate(batches(jcfg)):
        step = i + 1
        tb = {k: torch.as_tensor(v) for k, v in b.items()}
        tp = convert.params_from_reference(_np(jp), "cpu")
        jstate = _np(js)
        residual = jstate.pop("ef_residual", None)
        ts = convert.opt_state_from_reference(jstate, "cpu")
        if residual is not None:
            ts["ef_residual"] = convert.params_from_reference(residual, "cpu")
        # the gradients the step sees, held to the reference's within
        # delta, the limit the parameters' range is then taken over
        _, _, g = TL.value_and_grad(
            lambda q, x: (lm_common.loss_fn(q, tcfg, x), None), tp, tb)
        top = max(float(x.abs().max()) for x in tree.leaves(g))
        atol = (ATOL_SCALE_OF.get(arch, GRAD_ATOL_SCALE) if step == 1
                else LATER_ATOL_SCALE) * top
        jg = ref_grad_fn(arch)(jp, jax.tree.map(jnp.asarray, b))
        delta = tree.map(lambda x: GRAD_RTOL * x.abs() + atol, g)
        for path, x, y, d in zip(tree.leaf_paths(g), tree.leaves(g),
                                 jax.tree.leaves(jg), tree.leaves(delta)):
            y = torch.as_tensor(np.array(y))
            assert ((x - y).abs() <= d).all(), (
                step, path, float(((x - y).abs() / d).max()))
        if tt.compress_grads:
            corrected = tree.map(torch.add, g, ts["ef_residual"])
            g, _ = compression.ef_int8_roundtrip(g, ts["ef_residual"])
            delta = tree.map(lambda d, c: d + quantum(c), delta, corrected)
        spread = step_spread(tt, ts, g, tp, step, delta)

        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, b), step)
        tp, ts, tm = tstep(tp, ts, tb, step)
        yield step, jm, jp, js, tm, tp, ts, spread


def check_step(step, jm, jp, tm, tp, spread):
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5, err_msg=f"step {step}")
    for path, a, w, s in zip(tree.leaf_paths(tp), tree.leaves(tp),
                             jax.tree.leaves(jp), spread):
        a, w = a.numpy(), np.asarray(w)
        lim = 1e-4 * (np.abs(w) + LR) + s
        assert (np.abs(a - w) <= lim).all(), (step, path)


@pytest.mark.parametrize("arch", configs.all_archs())
def test_int8_moment_steps_match_the_reference(arch):
    for step, jm, jp, js, tm, tp, ts, spread in run_forced(arch, "int8"):
        check_step(step, jm, jp, tm, tp, spread)
        got, want = convert.opt_state_to_numpy(ts), _np(js)
        flips, total = 0, 0
        for key in ("m", "v"):
            for (q, sc), (jq, jsc) in zip(payloads(got, key),
                                          payloads(want, key)):
                d = np.abs(q.astype(int) - jq.astype(int))
                assert d.max() <= 1, (step, key)
                np.testing.assert_allclose(sc, jsc, rtol=1e-4, atol=1e-30)
                flips += int((d > 0).sum())
                total += d.size
        assert flips <= FLIP_SHARE * total, (step, flips, total)
