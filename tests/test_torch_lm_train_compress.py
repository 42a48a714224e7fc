"""``make_train_step`` with int8 error-feedback gradient compression
against the reference's jitted step at every registered architecture's
smoke config: three steps, each from the reference's own state (its
parameters, moments and EF residual), held as the int8-moment steps of
``test_torch_lm_train_int8.py`` are (its docstring gives the limits): the
loss, the parameters within the range the step takes while its
gradients move within their limit plus one int8 quantum of their block,
and EF residuals a quantum apart (a payload rounded the other way) on at
most 0.1% of the entries.
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch import configs, tree

from test_torch_lm_train_int8 import FLIP_SHARE, check_step, run_forced

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", configs.all_archs())
def test_compressed_gradient_steps_match_the_reference(arch):
    for step, jm, jp, js, tm, tp, ts, spread in run_forced(
            arch, compress_grads=True):
        check_step(step, jm, jp, tm, tp, spread)
        flips, total = 0, 0
        for r, jr in zip(tree.leaves(ts["ef_residual"]),
                         jax.tree.leaves(js["ef_residual"])):
            r, jr = r.numpy(), np.asarray(jr)
            # a payload rounded the other way puts its residual a quantum
            # (twice the largest residual of its block, at most) away
            far = np.abs(r - jr) > 1e-3 * np.abs(jr).max()
            flips += int(far.sum())
            total += r.size
        assert flips <= FLIP_SHARE * total, (step, flips, total)
