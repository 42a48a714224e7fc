"""The dry run"s cells on the (2, 16, 16) two-pod mesh: qwen3_8b,
mistral_nemo_12b, granite_3_8b; train_4k (see
``tests/torch_dryrun_cells.py``)."""
import pytest

from torch_dryrun_cells import check_cell, world  # noqa: F401


@pytest.mark.parametrize("shape", ("train_4k",))
@pytest.mark.parametrize("arch", (
    "qwen3_8b",
    "mistral_nemo_12b",
    "granite_3_8b",
))
def test_cell(arch, shape):
    check_cell(arch, shape, multi_pod=True)
