"""The dry run"s cells on the (2, 16, 16) two-pod mesh: whisper_tiny; train_4k
(see ``tests/torch_dryrun_cells.py``)."""
import pytest

from torch_dryrun_cells import check_cell, world  # noqa: F401


@pytest.mark.parametrize("shape", ("train_4k",))
@pytest.mark.parametrize("arch", ("whisper_tiny",))
def test_cell(arch, shape):
    check_cell(arch, shape, multi_pod=True)
