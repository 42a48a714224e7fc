"""The port's LM serving against the JAX package's: greedy ``generate`` for
every registered architecture from the same weights (the port's seeded
init, carried into the reference's tree through numpy: the same tokens), the positional-KV-pruned decode path, seeded sampling, the cache
converters, and the serve CLI's ``--mode lm``.

Greedy tokens must be equal. ``generate`` gives the transformer family
fp32 caches and the other families their default bf16 ones, as the
reference does; a token could only differ where two logits lie within a
bf16 ulp's effect of each other, and none does on these seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm_common as jlm
from repro.serving import lm_serve as jserve

from repro_torch import configs, convert
from repro_torch.launch import serve
from repro_torch.models import lm_common, transformer
from repro_torch.serving import lm_serve

torch.set_num_threads(1)

NEW = 6


def _weights(cfg):
    """The port's seeded weights, and the same numbers as the reference's
    tree (through numpy)."""
    tp = lm_common.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    return jax.tree.map(jnp.asarray, convert.params_to_numpy(tp)), tp


def _prompts(vocab, B=2, S=8, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("arch", configs.all_archs())
def test_greedy_generate_equals_the_reference(arch):
    jcfg = jconfigs.get(arch).smoke_config()
    tcfg = configs.get(arch).smoke_config()
    jp, tp = _weights(tcfg)
    prompts = _prompts(jcfg.vocab)
    want = jserve.generate(jp, jcfg, jnp.asarray(prompts),
                           jserve.ServeConfig(max_new_tokens=NEW))
    got = lm_serve.generate(tp, tcfg, torch.as_tensor(prompts),
                            lm_serve.ServeConfig(max_new_tokens=NEW))
    assert got["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    assert got["prefill_s"] > 0 and got["decode_s_per_tok"] > 0


def test_kv_prune_keep_decode_path_equals_the_reference():
    """qwen3 with kv_prune_keep = 4 of 14 cache slots: the pruned decode
    runs in every layer once the cache is longer than 4."""
    jcfg = jconfigs.get("qwen3_8b").smoke_config().replace(kv_prune_keep=4)
    tcfg = configs.get("qwen3_8b").smoke_config().replace(kv_prune_keep=4)
    jp, tp = _weights(tcfg)
    prompts = _prompts(jcfg.vocab)
    want = jserve.generate(jp, jcfg, jnp.asarray(prompts),
                           jserve.ServeConfig(max_new_tokens=NEW))
    got = lm_serve.generate(tp, tcfg, torch.as_tensor(prompts),
                            lm_serve.ServeConfig(max_new_tokens=NEW))
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    # the pruned path is taken: past 4 cached positions its logits leave
    # the full attention's
    def last_logits(cfg):
        caches = transformer.init_caches(cfg, 2, 14, torch.float32,
                                         device="cpu")
        for t in range(8):
            logits, caches = transformer.decode_step(
                tp, cfg, torch.as_tensor(prompts[:, t:t + 1]), caches)
        return logits

    assert (last_logits(tcfg) - last_logits(tcfg.replace(kv_prune_keep=0))
            ).abs().max() > 1e-3


def test_seeded_sampling_is_reproducible_and_supported():
    cfg = configs.get("granite_3_8b").smoke_config()
    params = lm_common.init_params(torch.Generator().manual_seed(0), cfg,
                                   "cpu")
    prompts = torch.as_tensor(_prompts(cfg.vocab, B=4))
    runs = [lm_serve.generate(params, cfg, prompts, lm_serve.ServeConfig(
        max_new_tokens=8, temperature=t, seed=s))["tokens"]
        for t, s in ((0.8, 1), (0.8, 1), (0.8, 2), (0.0, 1), (0.0, 2))]
    assert torch.equal(runs[0], runs[1])          # same seed, same tokens
    assert not torch.equal(runs[0], runs[2])      # another seed
    assert torch.equal(runs[3], runs[4])          # greedy ignores the seed
    assert not torch.equal(runs[0], runs[3])
    for r in runs:
        assert torch.equal(r[:, :8], prompts)
        assert int(r.min()) >= 0 and int(r.max()) < cfg.vocab


def test_gumbel_sampling_draws_from_the_softmax(monkeypatch):
    """Through ``generate``'s sampler on a stub family whose logits are
    fixed: 4,000 draws at T = 0.5 give each token its softmax(logits / T)
    share within 4 standard errors, and a -inf logit is never drawn."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0, float("-inf")]])

    class Stub:
        @staticmethod
        def init_caches(cfg, B, total, dtype=None, device=None):
            return {}

        @staticmethod
        def decode_step(params, cfg, tok, caches):
            return logits.expand(tok.shape[0], -1), caches

    monkeypatch.setitem(lm_common.FAMILIES, "transformer", Stub)
    cfg = configs.get("qwen3_8b").smoke_config()
    B = 4000
    out = lm_serve.generate(None, cfg, torch.zeros((B, 1), dtype=torch.int32),
                            lm_serve.ServeConfig(max_new_tokens=1,
                                                 temperature=0.5, seed=3))
    drawn = out["tokens"][:, 1]
    freq = torch.bincount(drawn, minlength=5).double() / B
    p = torch.softmax(logits[0].double() / 0.5, -1)
    assert freq[4] == 0
    assert ((freq - p).abs() <= 4 * (p * (1 - p) / B).sqrt() + 1e-12).all()


def test_lm_caches_convert_both_ways_with_bf16_leaves():
    jcfg = jconfigs.get("recurrentgemma_9b").smoke_config()
    jc = jlm.FAMILIES["rglru"].init_caches(jcfg, 2, 12)
    jc = jax.tree.map(lambda a: a + jnp.asarray(0.5, a.dtype)
                      if jnp.issubdtype(a.dtype, jnp.floating) else a, jc)
    tc = convert.params_from_reference(jax.tree.map(np.asarray, jc), "cpu")
    assert tc["l0"]["conv"].dtype == torch.bfloat16
    assert tc["l2"]["k_pos"].dtype == torch.int32
    back = convert.params_to_numpy(tc)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jc)):
        np.testing.assert_array_equal(a, np.asarray(b).astype(a.dtype))


def test_serve_cli_mode_lm_runs_on_cpu(capsys):
    out = serve.main(["--mode", "lm", "--arch", "qwen3_8b", "--batch", "2",
                      "--new-tokens", "4", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("generated (2, 12); prefill ")
    assert line.endswith("ms/token")
    assert tuple(out["tokens"].shape) == (2, 12)
    # the reference's prompts: RandomState(0), 8 tokens, over the vocab
    want = np.random.RandomState(0).randint(0, 512, size=(2, 8))
    np.testing.assert_array_equal(out["tokens"][:, :8].numpy(), want)


def test_serve_cli_mode_lm_refuses_tgn_flags_and_needs_a_device(monkeypatch):
    with pytest.raises(SystemExit):
        serve.main(["--mode", "lm", "--guard", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--mode", "lm", "--batch", "2"])
