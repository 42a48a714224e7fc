"""The control, the reference in TF32 in the program's place, fails the
cell's limits at a small size on the CPU."""
import pytest

from tgnbench import harness
from tgnbench.small import CELLS, SMALL, bench, load_cell


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    limits = load_cell(cell)["limits"]
    got = harness.control(cell, 11, 12, "cpu", overrides=SMALL,
                          bench=bench())
    assert any(got[k] > limits[k] for k in limits), got
