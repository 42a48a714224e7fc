"""chip_smoke's full-width LM checks (``launch/lm_smoke``), driven on the
CPU at each architecture's smoke width: decode against prefill with the
planted fault, the served replay and its decode bound, and the chunked
prefill against one block. The full configs themselves run only on the
card; here the same functions see the smoke configs.

Tolerances are lm_smoke's own (``TOL_FULL_F32`` 1e-4, ``TOL_FULL_BF16``
atol 0.25), and the planted faults must read above them.
"""
import pytest
import torch

from repro_torch import configs
from repro_torch.core import perf_model
from repro_torch.launch import lm_smoke, main_path as mp
from repro_torch.models import lm_common, transformer

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _smoke(arch, dtype="float32"):
    cfg = configs.get(arch).smoke_config().replace(dtype=dtype)
    params = lm_common.init_params(
        torch.Generator().manual_seed(mp.LM_SEED), cfg, CPU)
    return cfg, params


@pytest.mark.parametrize("arch", mp.LM_FULL)
def test_fp32_decode_matches_prefill_and_rejects_the_planted_fault(arch):
    cfg, params = _smoke(arch)
    fam = lm_common.family_of(cfg)
    prompts = mp.lm_prompts(cfg.vocab, mp.LM_SMOKE_B)
    extra = (torch.randn((mp.LM_SMOKE_B, cfg.n_frames, cfg.d_model),
                         generator=torch.Generator().manual_seed(1))
             if fam == "whisper" else None)
    plant = "bf16 scores" if fam == "transformer" else None
    res = lm_smoke.decode_vs_prefill(arch, cfg, params, prompts, CPU, "cpu",
                                     lm_smoke.TOL_FULL_F32, extra, plant)
    assert res["err"] <= lm_smoke.TOL_FULL_F32["atol"]
    if plant is not None:
        assert res["rejected"]
        assert res["planted_err"] > lm_smoke.TOL_FULL_F32["atol"]


def test_bf16_decode_matches_prefill():
    cfg, params = _smoke("qwen3_8b", "bfloat16")
    res = lm_smoke.decode_vs_prefill(
        "qwen3_8b bf16", cfg, params, mp.lm_prompts(cfg.vocab, 2), CPU,
        "cpu", lm_smoke.TOL_FULL_BF16, plant="bf16 scores")
    assert res["err"] <= lm_smoke.TOL_FULL_BF16["atol"]
    assert res["planted_err"] is not None


def test_chunked_prefill_matches_one_block_and_rejects_no_rescale():
    cfg, params = _smoke("qwen3_8b", "bfloat16")
    S = 4 * cfg.k_block
    res = lm_smoke.long_prefill(cfg, params, CPU, "cpu", S,
                                plant="no rescale")
    assert res["err"] <= lm_smoke.TOL_FULL_BF16["atol"]
    assert res["h_err"] <= lm_smoke.TOL_FULL_BF16["atol"]
    assert res["rejected"]
    assert max(res["planted_errs"]) > lm_smoke.TOL_FULL_BF16["atol"]


def test_long_prefill_needs_several_blocks_each_way():
    cfg, params = _smoke("qwen3_8b", "bfloat16")
    with pytest.raises(RuntimeError, match="several blocks"):
        lm_smoke.long_prefill(cfg, params, CPU, "cpu", cfg.k_block)


def test_serve_full_replays_generate_and_bounds_the_bytes_it_needs():
    cfg, params = _smoke("qwen3_8b", "bfloat16")
    res = lm_smoke.serve_full(cfg, params, CPU, "cpu")
    B = mp.LM_B
    kv = lm_smoke._bytes_of(transformer.init_caches(
        cfg, B, mp.LM_PROMPT + mp.LM_NEW, torch.float32, device=CPU))
    # every parameter but the embedding table, which a token gathers B
    # rows of, and the KV cache
    need = ((cfg.n_params - cfg.vocab * cfg.d_model) * 4
            + B * cfg.d_model * 4 + kv)
    rl = perf_model.roofline(2.0 * cfg.n_active_params * B, need,
                             precision="bf16")
    assert res["bound_ms"] == pytest.approx(
        max(rl.compute_s, rl.memory_s) * 1e3, rel=1e-12)
    assert res["decode_ms"] > 0 and res["prefill_ms"] > 0


@pytest.mark.parametrize("fault", sorted(lm_smoke.PLANTS))
def test_planted_puts_the_sound_function_back(fault):
    mod, name, _ = lm_smoke.PLANTS[fault]
    sound = getattr(mod, name)
    with pytest.raises(KeyError):
        with lm_smoke.planted(fault):
            assert getattr(mod, name) is not sound
            raise KeyError
    assert getattr(mod, name) is sound
