"""The port's language-model families against the JAX package's, for every
registered architecture: configs field by field, parameter counts, the
parameter tree's paths, shapes and deterministic leaves, ``prefill`` and
three ``decode_step``s from the reference's weights (logits and caches),
and the cross K/V that whisper and the vision LM compute from their
encoder / vision inputs.

Smoke configs only, as the reference's own tests (fp32). Tolerances:
``TOL`` (rtol = atol = 1e-5) for fp32 caches; the recurrent families'
default bf16 caches at ``BF16_TOL`` (a 1-ulp fp32 difference before a
bf16 rounding can move the rounded value by one bf16 ulp, 2^-8 of it, and
the next steps read it). Integer leaves (``pos``, ring ``k_pos``) are
equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm_common as jlm
from repro.models import vision_lm as jvision
from repro.models import whisper as jwhisper

from repro_torch import configs, convert, tree
from repro_torch.models import lm_common, vision_lm, whisper

torch.set_num_threads(1)

ARCHS = configs.all_archs()
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
B, S = 2, 8
#: leaf names the reference initialises without a random key
FIXED_LEAVES = {"scale", "bias", "bq", "bv", "bo", "conv_b", "b_a", "b_x",
                "lam", "a_log", "d_skip", "dt_bias", "gate_attn", "gate_ffn"}


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), err_msg=what,
                               **tol)


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg = jconfigs.get(arch).smoke_config()
    tcfg = configs.get(arch).smoke_config()
    jp = jlm.init_params(jax.random.key(0), jcfg)
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _inputs(cfg):
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)
    fam = jlm.family_of(cfg)
    extra = None
    if fam in ("whisper", "vision_lm"):
        n = cfg.n_frames if fam == "whisper" else cfg.n_patches
        extra = rng.randn(B, n, cfg.d_model).astype(np.float32)
    return toks, extra


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference_field_by_field(arch):
    jspec, tspec = jconfigs.get(arch), configs.get(arch)
    for which in ("config", "smoke_config"):
        jcfg, tcfg = getattr(jspec, which)(), getattr(tspec, which)()
        assert type(tcfg).__name__ == type(jcfg).__name__
        assert tcfg.asdict() == jcfg.asdict()
        assert tcfg.n_params == jcfg.n_params
        assert tcfg.n_active_params == jcfg.n_active_params
        assert lm_common.family_of(tcfg) == jlm.family_of(jcfg)
        assert lm_common.supports_long_context(tcfg) == \
            jlm.supports_long_context(jcfg)
        assert lm_common.has_decode(tcfg)
        assert tcfg.compute_dtype == (torch.bfloat16 if jcfg.dtype ==
                                      "bfloat16" else torch.float32)
    for attr in ("shard_mode", "moment_dtype", "grad_accum"):
        assert getattr(tspec, attr) == getattr(jspec, attr)
    assert configs.all_archs() == jconfigs.all_archs()
    assert configs.SHAPES == jconfigs.SHAPES


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_has_the_reference_paths_shapes_and_fixed_leaves(arch):
    jcfg = jconfigs.get(arch).smoke_config()
    tcfg = configs.get(arch).smoke_config()
    want = dict(jax.tree_util.tree_flatten_with_path(
        jlm.abstract_params(jcfg))[0])
    want = {".".join(str(k.key) for k in path): leaf
            for path, leaf in want.items()}
    tp = lm_common.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    got = dict(tree.flatten_with_path(tp))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        assert tuple(leaf.shape) == tuple(want[path].shape), path
        assert leaf.dtype == torch.float32, path
    # leaves the reference draws from no key (norms, biases, gates, decay
    # tables) equal its values; drawn leaves are seeded, not the same bits
    ref = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, _model(arch)[2]))[0])
    fixed = 0
    for path, a in ref.items():
        name = ".".join(str(k.key) for k in path)
        if path[-1].key in FIXED_LEAVES:
            fixed += 1
            _close(got[name], a, dict(rtol=1e-6, atol=1e-6), name)
    assert fixed > 0
    again = lm_common.init_params(torch.Generator().manual_seed(0), tcfg,
                                  "cpu")
    for a, b in zip(tree.leaves(tp), tree.leaves(again)):
        assert torch.equal(a, b)                   # seeded


def _prefill(mod, cfg, params, toks, extra, T, jit=lambda f: f):
    """The family's prefill logits; ``jit`` wraps the reference's call (one
    compile in place of JAX's op-by-op ones)."""
    fam = mod.__name__.rsplit(".", 1)[-1]
    if fam == "whisper":
        return jit(lambda p, a, b: mod.prefill(p, cfg, a, b)[0])(
            params, T(extra), T(toks))
    if fam == "vision_lm":
        return jit(lambda p, a, b: mod.prefill(p, cfg, a, b)[0])(
            params, T(toks), T(extra))
    return jit(lambda p, a: mod.prefill(p, cfg, a)[0])(params, T(toks))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch):
    jcfg, tcfg, jp, tp = _model(arch)
    fam = jlm.family_of(jcfg)
    jm, tm = jlm.FAMILIES[fam], lm_common.FAMILIES[fam]
    toks, extra = _inputs(jcfg)
    _close(_prefill(tm, tcfg, tp, toks, extra, torch.as_tensor),
           _prefill(jm, jcfg, jp, toks, extra, jnp.asarray, jax.jit),
           what="prefill")
    jdecode = jax.jit(lambda p, t, c: jm.decode_step(p, jcfg, t, c))
    # fp32 caches, and the recurrent families' default (bf16) caches
    dtypes = [(jnp.float32, torch.float32, TOL)]
    if fam != "transformer":
        dtypes.append((jnp.bfloat16, torch.bfloat16, BF16_TOL))
    for jdt, tdt, tol in dtypes:
        jc = jm.init_caches(jcfg, B, 12, dtype=jdt)
        tc = convert.params_from_reference(jax.tree.map(np.asarray, jc),
                                           "cpu")
        for a, b in zip(tree.leaves(tc), jax.tree.leaves(jc)):
            assert a.dtype == (tdt if b.dtype == jdt else
                               {jnp.dtype("float32"): torch.float32,
                                jnp.dtype("int32"): torch.int32}[b.dtype])
        for t in range(3):
            jl, jc = jdecode(jp, jnp.asarray(toks[:, t:t + 1]), jc)
            tl, tc = tm.decode_step(tp, tcfg, torch.as_tensor(
                toks[:, t:t + 1]), tc)
            _close(tl, jl, tol, f"decode step {t} ({tdt})")
        want = dict(jax.tree_util.tree_flatten_with_path(jc)[0])
        want = {".".join(str(k.key) for k in p): v for p, v in want.items()}
        got = dict(tree.flatten_with_path(tc))
        assert sorted(got) == sorted(want)
        for path, a in got.items():
            b = np.asarray(want[path])
            assert tuple(a.shape) == b.shape, path
            if np.issubdtype(b.dtype, np.integer):
                np.testing.assert_array_equal(a.numpy(), b, err_msg=path)
            else:
                # the reference keeps a recurrent layer's new conv tail in
                # the compute dtype, and so does the port
                assert str(a.dtype).split(".")[-1] == b.dtype.name, path
                _close(convert.params_to_numpy(a), b.astype(np.float32),
                       tol, path)


def test_decode_unroll_and_scan_give_the_same_result():
    """The reference's two decode forms agree, and the port (one loop over
    the stacked blocks) equals both."""
    jcfg, tcfg, jp, tp = _model("gemma3_12b")
    toks, _ = _inputs(jcfg)
    jm, tm = jlm.FAMILIES["transformer"], lm_common.FAMILIES["transformer"]
    outs = []
    for unroll in (False, True):
        cfg = jcfg.replace(decode_unroll=unroll)
        jc = jm.init_caches(cfg, B, 12, dtype=jnp.float32)
        jdecode = jax.jit(lambda p, t, c: jm.decode_step(p, cfg, t, c))
        for t in range(3):
            jl, jc = jdecode(jp, jnp.asarray(toks[:, t:t + 1]), jc)
        outs.append(np.asarray(jl))
    tc = tm.init_caches(tcfg.replace(decode_unroll=True), B, 12,
                        torch.float32, device="cpu")
    for t in range(3):
        tl, tc = tm.decode_step(tp, tcfg.replace(decode_unroll=True),
                                torch.as_tensor(toks[:, t:t + 1]), tc)
    _close(outs[1], outs[0])
    _close(tl, outs[0])


@pytest.mark.parametrize("arch", ["whisper_tiny", "llama32_vision_11b"])
def test_cross_kv_from_encoder_or_vision_match_the_reference(arch):
    jcfg, tcfg, jp, tp = _model(arch)
    toks, extra = _inputs(jcfg)
    if arch == "whisper_tiny":
        jenc = jax.jit(lambda p, f: jwhisper.encode(p, jcfg, f))(
            jp, jnp.asarray(extra))
        enc = whisper.encode(tp, tcfg, torch.as_tensor(extra))
        _close(enc, jenc, what="encode")
        jc = jwhisper.init_caches(jcfg, B, 12, params=jp, enc_out=jenc)
        tc = whisper.init_caches(tcfg, B, 12, params=tp, enc_out=enc)
        _close(whisper.decode_train(tp, tcfg, torch.as_tensor(toks), enc),
               jwhisper.decode_train(jp, jcfg, jnp.asarray(toks), jenc),
               what="decode_train")
        jm, tm = jwhisper, whisper
    else:
        jc = jvision.init_caches(jcfg, B, 12, params=jp,
                                 vision=jnp.asarray(extra))
        tc = vision_lm.init_caches(tcfg, B, 12, params=tp,
                                   vision=torch.as_tensor(extra))
        jm, tm = jvision, vision_lm
    for k in ("cross_k", "cross_v"):
        assert tc[k].dtype == torch.bfloat16
        _close(convert.params_to_numpy(tc[k]),
               np.asarray(jc[k], np.float32), BF16_TOL, k)
    # and decoding against them (bf16 caches)
    jdecode = jax.jit(lambda p, t, c: jm.decode_step(p, jcfg, t, c))
    for t in range(2):
        jl, jc = jdecode(jp, jnp.asarray(toks[:, t:t + 1]), jc)
        tl, tc = tm.decode_step(tp, tcfg, torch.as_tensor(toks[:, t:t + 1]),
                                tc)
        _close(tl, jl, BF16_TOL, f"decode step {t}")
