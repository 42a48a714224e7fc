"""The port's language-model serving path on the card against the CPU.

Every test here is marked ``cuda`` and skips where there is no CUDA device.
On a GPU machine run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lm_cuda.py

The module imports neither JAX nor the reference package. Three smoke
configs (a dense GQA transformer with qk-norm, an MoE transformer, and the
RG-LRU hybrid with ring caches) are served on the card and on the CPU from
the same weights (``launch/lm_smoke.smoke_arch``): prefill logits, decode
over the prompt and the CPU's greedy tokens, the final caches, and the MoE
dispatch tables, to ``lm_smoke.TOL_SMOKE`` (rtol = atol = 1e-4: fp32 sums
in other orders over 24 chained steps), integer leaves equal; then greedy
``generate`` on the card takes the CPU's tokens, and the serve CLI's
``--mode lm`` runs on the card without ``--device``.
"""
import pytest
import torch

from repro_torch import configs
from repro_torch.launch import lm_smoke, serve
from repro_torch.models import lm_common
from repro_torch.serving import lm_serve


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3_8b", "dbrx_132b",
                                  "recurrentgemma_9b"])
def test_smoke_arch_on_the_card_matches_the_cpu(cuda_device, arch):
    errs = lm_smoke.smoke_arch(arch, configs.get(arch).smoke_config(),
                               cuda_device, torch.cuda.get_device_name(0))
    assert max(errs.values()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite_3_8b", "mamba2_130m"])
def test_greedy_generate_on_the_card_takes_the_cpus_tokens(cuda_device,
                                                           arch):
    cfg = configs.get(arch).smoke_config()
    params = lm_common.init_params(torch.Generator().manual_seed(0), cfg,
                                   "cpu")
    prompts = torch.randint(0, cfg.vocab, (2, 8), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1))
    scfg = lm_serve.ServeConfig(max_new_tokens=8)
    want = lm_serve.generate(params, cfg, prompts, scfg)["tokens"]
    got = lm_serve.generate(lm_smoke.to_device(params, cuda_device), cfg,
                            prompts.to(cuda_device), scfg)["tokens"]
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_serve_cli_mode_lm_runs_on_the_card(cuda_device, capsys):
    out = serve.main(["--mode", "lm", "--arch", "qwen3_8b", "--batch", "4"])
    assert out["tokens"].device.type == "cuda"
    assert tuple(out["tokens"].shape) == (4, 24)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("generated (4, 24); prefill ")
