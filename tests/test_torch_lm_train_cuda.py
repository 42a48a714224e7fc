"""The port's language-model training path on the card against the CPU.

Every test here is marked ``cuda`` and skips where there is no CUDA device.
On a GPU machine run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lm_train_cuda.py

The module imports neither JAX nor the reference package. Under
deterministic algorithms (``utils.deterministic``), three smoke configs
(a dense GQA transformer with qk-norm, an MoE transformer, and the SSD
model) take one ``make_train_step`` step on the card and on the CPU from
the same weights and batch (``launch/lm_train_smoke.smoke_step``): the
loss (rtol 1e-5), every gradient leaf (|d| <= 1e-4 |g| + 1e-6 max|g|) and
every updated parameter (the first step's move under that gradient
limit), qwen3's also with ``grad_accum = 2`` and ``compress_grads``; then
``--mode lm`` runs on the card without ``--device``, and killed after its
step-3 checkpoint and rerun it ends with an uninterrupted run's bits.
"""
import pytest
import torch

from repro_torch import configs
from repro_torch.launch import lm_train_smoke, train
from repro_torch.utils import deterministic


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch,label,kw", [
    ("qwen3_8b", "", {}),
    ("dbrx_132b", "", {}),
    ("mamba2_130m", "", {}),
    ("qwen3_8b", "grad_accum=2", {"grad_accum": 2}),
    ("qwen3_8b", "compress_grads", {"compress_grads": True}),
])
def test_train_step_on_the_card_matches_the_cpu(cuda_device, arch, label,
                                                 kw):
    with deterministic():
        out = lm_train_smoke.smoke_step(
            arch, configs.get(arch).smoke_config(), cuda_device,
            torch.cuda.get_device_name(0), label, **kw)
    assert out["loss"] <= lm_train_smoke.LOSS_RTOL
    assert out["grads"] <= 1.0 and out["params"] <= 1.0


@pytest.mark.cuda
def test_train_cli_mode_lm_runs_on_the_card(cuda_device):
    out = train.main(["--mode", "lm", "--arch", "qwen3_8b", "--steps", "2",
                      "--batch", "2", "--seq", "32"])
    assert out["params"]["embed"]["embed"].device.type == "cuda"
    assert len(out["losses"]) == 2
    assert all(torch.isfinite(torch.tensor(out["losses"])))


@pytest.mark.cuda
def test_train_cli_killed_and_resumed_on_the_card_is_bitwise(cuda_device):
    out = lm_train_smoke.cli_resume(cuda_device,
                                    torch.cuda.get_device_name(0))
    assert out == {"resumed": True, "equal": True}
