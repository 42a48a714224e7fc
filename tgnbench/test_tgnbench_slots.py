"""A fault in one slot of the coalesced round, in a tenant the output check
does not replay from the start, is caught by the last round's check of
every tenant."""
import pytest

from tgnbench import faults, harness
from tgnbench.small import CELLS, SMALL, run

SEED = 20261
#: one tenant of three replayed from the start
ONE_CHECKED = {**SMALL, "mix": {**SMALL["mix"], "check_tenants": 1}}


def test_the_altered_slot_is_not_replayed():
    mix = {**harness.load_cell(CELLS[0])["mix"], **ONE_CHECKED["mix"]}
    checked, _, _ = harness.plan(mix, SEED)
    # one_slot_altered alters the last tenant's answers
    assert checked and mix["tenants"] - 1 not in checked


@pytest.mark.parametrize("cell", CELLS)
def test_one_slot_altered_is_not_correct(cell):
    with faults.plant("one_slot_altered"):
        out = run(cell, seed=SEED, overrides=ONE_CHECKED)
    assert out["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_one_replayed_tenant_is_correct_without_a_fault(cell):
    assert run(cell, seed=SEED, overrides=ONE_CHECKED)["correct"]
