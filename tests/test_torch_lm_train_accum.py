"""``make_train_step`` with ``grad_accum = 2`` against the reference's
jitted step, at every registered architecture's smoke config: three-step
trajectories from the reference's weights, with the tolerances and
helpers of ``test_torch_lm_train_steps.py``. Two micro-batches of 2:
losses and gradients summed in fp32 in order, then halved, as the
reference's scan does.
"""
import pytest
import torch

from repro_torch import configs

from test_torch_lm_train_steps import check_trajectory, run_both

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", configs.all_archs())
def test_three_steps_with_grad_accum_match_the_reference(arch):
    check_trajectory(arch, *run_both(arch, grad_accum=2))
