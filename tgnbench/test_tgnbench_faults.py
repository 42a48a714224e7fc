"""Each fault a run of these cells can have, planted in the timed path of a
whole run on the CPU at a small size, reads ``correct`` false."""
import pytest

from tgnbench import faults
from tgnbench.small import CELLS, run


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered",
                                   "half_batch_left_out"])
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(cell, fault):
    with faults.plant(fault):
        out = run(cell)
    assert out["correct"] is False
