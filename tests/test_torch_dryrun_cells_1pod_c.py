"""The dry run"s cells on the (16, 16) one-pod mesh: whisper_tiny,
recurrentgemma_9b, llama32_vision_11b; train_4k, prefill_32k, decode_32k,
long_500k (see ``tests/torch_dryrun_cells.py``)."""
import pytest

from torch_dryrun_cells import check_cell, world  # noqa: F401


@pytest.mark.parametrize("shape", (
    "train_4k",
    "prefill_32k",
    "decode_32k",
    "long_500k",
))
@pytest.mark.parametrize("arch", (
    "whisper_tiny",
    "recurrentgemma_9b",
    "llama32_vision_11b",
))
def test_cell(arch, shape):
    check_cell(arch, shape, multi_pod=False)
