"""The port's language-model training half against the JAX package: every
registered architecture's ``loss_fn`` and its gradients from the
reference's weights, the remat policies, and the Mamba-2 intra-chunk
decay whose reference backward overflows (compression and the specs are
in ``test_torch_lm_train_io.py``).

Smoke configs (fp32), B x S = 2 x 64: two loss chunks, 4 x 4 query x key
blocks, four SSD chunks. Tolerances: losses rtol 1e-5 (fp32 sums in other
orders; they read <= 1.5e-7); each gradient leaf rtol 1e-4 plus an atol
of 1e-6 times the tree's largest gradient (entries that are rounding
noise on both sides; the worst leaf, the embedding table whose repeated
tokens are summed in another order, reads up to 0.83 of it), but 1e-5
for the RG-LRU hybrid: the reference runs its recurrence as an
associative scan and the port as a loop, so every product associates
otherwise, and the backward carries that through the 64 steps (the
embedding's smallest entries read up to 2.4e-6 off). The remat
policies and the query-block remat recompute the same ops, so they are
held bitwise.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.distributed import checkpoint as jckpt
from repro.models import lm_common as jlm
from repro.models import mamba2 as jmamba

from repro_torch import configs, convert, tree
from repro_torch.launch import lm_smoke
from repro_torch.models import layers as L
from repro_torch.models import lm_common, mamba2
from repro_torch.training import train_loop as TL

torch.set_num_threads(1)

ARCHS = configs.all_archs()
B, S = 2, 64
LOSS_TOL = dict(rtol=1e-5, atol=0.0)
GRAD_RTOL, GRAD_ATOL_SCALE = 1e-4, 1e-6
ATOL_SCALE_OF = {"recurrentgemma_9b": 1e-5}
#: one architecture of each code path the remat policies wrap: dense GQA,
#: sliding windows, MoE, SSD, encoder-decoder, RG-LRU, gated cross layers
REMAT_ARCHS = ("qwen3_8b", "gemma3_12b", "dbrx_132b", "mamba2_130m",
               "whisper_tiny", "recurrentgemma_9b", "llama32_vision_11b")
#: the narrowest Mamba-2 whose reference gradients go non-finite: one
#: layer, 4 heads, a single SSD chunk of 256
NARROW_MAMBA = dict(arch="mamba2_narrow", n_layers=1, d_model=32, expand=2,
                    d_head=16, d_state=16, n_groups=1, conv_width=4,
                    vocab=256, chunk=256, dtype="float32", loss_chunk=256)


def _np(t):
    return jax.tree.map(np.asarray, t)


def batch_np(cfg, batch=B, seq=S, seed=0) -> dict:
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab, (batch, seq)).astype(np.int32)
    out = {"tokens": toks, "targets": np.roll(toks, -1, 1)}
    fam = jlm.family_of(cfg)
    if fam == "whisper":
        out["frames"] = rng.randn(batch, cfg.n_frames,
                                  cfg.d_model).astype(np.float32)
    if fam == "vision_lm":
        out["vision"] = rng.randn(batch, cfg.n_patches,
                                  cfg.d_model).astype(np.float32)
    return out


def torch_batch(b: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in b.items()}


def port_loss_and_grads(cfg, params, batch):
    loss, _, grads = TL.value_and_grad(
        lambda p, x: (lm_common.loss_fn(p, cfg, x), None), params, batch)
    return loss, grads


def ref_loss_and_grads(jcfg, jparams, b):
    fn = jax.jit(jax.value_and_grad(lambda p, x: jlm.loss_fn(p, jcfg, x)))
    return fn(jparams, {k: jnp.asarray(v) for k, v in b.items()})


def check_grads(got, want, where="", atol_scale=GRAD_ATOL_SCALE):
    assert tree.leaf_paths(got) == jckpt._leaf_paths(want)
    want = [np.asarray(w) for w in jax.tree.leaves(want)]
    atol = atol_scale * max(float(np.abs(w).max()) for w in want)
    for path, g, w in zip(tree.leaf_paths(got), tree.leaves(got), want):
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL, atol=atol,
                                   err_msg=f"{where}: {path}")


@functools.lru_cache(maxsize=None)
def _arch(arch):
    """(reference cfg, port cfg, reference params, port params, batch,
    reference loss, reference grads)."""
    jcfg = jconfigs.get(arch).smoke_config()
    tcfg = configs.get(arch).smoke_config()
    jp = jlm.init_params(jax.random.key(0), jcfg)
    tp = convert.params_from_reference(_np(jp), "cpu")
    b = batch_np(jcfg)
    jl, jg = ref_loss_and_grads(jcfg, jp, b)
    return jcfg, tcfg, jp, tp, b, jl, jg


# ---------------------------------------------------------------------------
# losses and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_the_reference(arch):
    jcfg, tcfg, _, tp, b, jl, jg = _arch(arch)
    loss, grads = port_loss_and_grads(tcfg, tp, torch_batch(b))
    np.testing.assert_allclose(float(loss), float(jl), **LOSS_TOL)
    check_grads(grads, jg, arch, ATOL_SCALE_OF.get(arch, GRAD_ATOL_SCALE))
    # the ``train_inputs`` layout is what ``loss_fn`` takes
    specs = lm_common.train_inputs(tcfg, B, S)
    assert set(specs) == set(b)


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_policies_and_attn_remat_are_bitwise(arch):
    """remat "none" / "nothing" / "dots" and, in the transformer, the
    query-block remat on and off: the same loss and gradients, bit for
    bit (the counterpart of test_perf_variants' attn_remat check)."""
    base = configs.get(arch).smoke_config()
    _, _, _, tp, b, _, _ = _arch(arch)
    batch = torch_batch(b)
    variants = [dict(remat=r) for r in ("none", "nothing", "dots")]
    if lm_common.family_of(base) == "transformer":
        variants += [dict(remat=r, attn_remat=True)
                     for r in ("none", "nothing", "dots")]
    want_l, want_g = port_loss_and_grads(base.replace(**variants[0]), tp,
                                         batch)
    for v in variants[1:]:
        loss, grads = port_loss_and_grads(base.replace(**v), tp, batch)
        assert torch.equal(loss, want_l), v
        for path, g, w in zip(tree.leaf_paths(grads), tree.leaves(grads),
                              tree.leaves(want_g)):
            assert torch.equal(g, w), (v, path)


def test_remat_runs_the_function_plainly_without_autograd():
    calls = []

    def fn(x):
        calls.append(torch.is_grad_enabled())
        return torch.sin(x)

    x = torch.ones(3, requires_grad=True)
    with torch.no_grad():
        assert torch.equal(L.remat(fn)(x), torch.sin(torch.ones(3)))
    assert calls == [False]
    for mode in ("nothing", "dots"):
        x.grad = None
        calls.clear()
        L.remat(fn, mode)(x).sum().backward()
        assert torch.equal(x.grad, torch.cos(torch.ones(3)))
        assert calls == [True, True], mode    # the backward recomputed it
    with pytest.raises(ValueError):
        L.remat(fn, "everything")


def test_whisper_tied_embedding_gradient_sums_both_uses():
    """The unembedding is the embedding table transposed: its gradient is
    the token gather's plus the logits', as the reference's."""
    jcfg, tcfg, _, tp, b, _, jg = _arch("whisper_tiny")
    _, grads = port_loss_and_grads(tcfg, tp, torch_batch(b))
    emb = grads["embed"]["embed"]
    unseen = np.setdiff1d(np.arange(tcfg.vocab), b["tokens"])
    # rows no token gathers still get the logits' gradient, as in the
    # reference
    rows = torch.as_tensor(unseen)
    assert float(emb[rows].abs().min()) > 0
    assert float(np.abs(np.asarray(jg["embed"]["embed"])[unseen]).min()) > 0


# ---------------------------------------------------------------------------
# MoE's backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
def test_moe_ffn_gradients_match_the_reference_and_the_dense_oracle(
        capacity_factor):
    """``moe_ffn``'s backward through autograd (the dispatch gather, the
    expert einsums, the combine's gather) against ``jax.grad`` of the
    reference's, for the input and every weight; with ample capacity
    (no slot dropped) also against the dense ``moe_ffn_ref``'s. With a
    router biased to expert 0, a capacity factor of 1.25 (256 slots an
    expert for 384 tokens x 2) drops slots; 8.0 drops none."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe

    T, D, F, E, k = 384, 16, 32, 4, 2
    jp = jmoe.init_moe(jax.random.key(3), D, F, E)
    router = np.asarray(jp["router"]).copy()
    router[0, 0] = 8.0
    jp["router"] = jnp.asarray(router)
    x = np.random.RandomState(4).randn(T, D).astype(np.float32)
    x[:, 0] = np.abs(x[:, 0])
    w = np.random.RandomState(5).randn(T, D).astype(np.float32)

    def jloss(p, a):
        return jnp.sum(jmoe.moe_ffn(p, a, k, capacity_factor=capacity_factor)
                       * w)

    jg_p, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = convert.params_from_reference(_np(jp), "cpu")
    xt = torch.as_tensor(x)
    _, keep, _ = moe.build_dispatch(moe.route(tp["router"], xt, k)[0], E,
                                    moe.capacity(T, E, k, capacity_factor))
    assert bool(keep.all()) == (capacity_factor > 2)

    def grads(fn):
        live = {n: v.clone().requires_grad_(True) for n, v in tp.items()}
        xl = xt.clone().requires_grad_(True)
        torch.sum(fn(live, xl) * torch.as_tensor(w)).backward()
        return {n: v.grad for n, v in live.items()}, xl.grad

    g_p, g_x = grads(lambda p, a: moe.moe_ffn(
        p, a, k, capacity_factor=capacity_factor))
    for n in sorted(g_p):
        np.testing.assert_allclose(g_p[n].numpy(), np.asarray(jg_p[n]),
                                   rtol=1e-4, atol=1e-5, err_msg=n)
    np.testing.assert_allclose(g_x.numpy(), np.asarray(jg_x), rtol=1e-4,
                               atol=1e-5)
    if capacity_factor > 2:
        r_p, r_x = grads(lambda p, a: moe.moe_ffn_ref(p, a, k))
        for n in sorted(g_p):
            np.testing.assert_allclose(g_p[n].numpy(), r_p[n].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=n)
        np.testing.assert_allclose(g_x.numpy(), r_x.numpy(), rtol=1e-4,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# Mamba-2: the intra-chunk decay
# ---------------------------------------------------------------------------


def _narrow_mamba():
    jcfg = jmamba.MambaConfig(**NARROW_MAMBA)
    tcfg = mamba2.MambaConfig(**NARROW_MAMBA)
    jp = jlm.init_params(jax.random.key(0), jcfg)
    return jcfg, tcfg, jp, convert.params_from_reference(_np(jp), "cpu")


def test_mamba2_chunk256_reference_gradients_overflow_and_the_ports_do_not():
    """At one SSD chunk of 256 the reference's ``exp`` of the unmasked
    exponents overflows above the diagonal, and its backward multiplies
    the masked zeros by inf: non-finite gradient leaves. The port masks
    the exponent first: finite gradients, the same loss."""
    jcfg, tcfg, jp, tp = _narrow_mamba()
    b = batch_np(jcfg, batch=1, seq=256)
    jl, jg = ref_loss_and_grads(jcfg, jp, b)
    bad = [p for p, g in zip(jckpt._leaf_paths(jg), jax.tree.leaves(jg))
           if not np.isfinite(np.asarray(g)).all()]
    assert np.isfinite(float(jl)) and len(bad) >= 3, bad
    loss, grads = port_loss_and_grads(tcfg, tp, torch_batch(b))
    assert all(bool(torch.isfinite(g).all()) for g in tree.leaves(grads))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    # the reference's form, planted in the port: the loss is bitwise the
    # port's, and the gradients of the same leaves go non-finite
    with lm_smoke.planted("unmasked exponent"):
        loss_ref_form, g_ref_form = port_loss_and_grads(tcfg, tp,
                                                        torch_batch(b))
    assert torch.equal(loss_ref_form, loss)
    bad_port = [p for p, g in zip(tree.leaf_paths(g_ref_form),
                                  tree.leaves(g_ref_form))
                if not bool(torch.isfinite(g).all())]
    assert bad_port == bad


def test_mamba2_masked_decay_is_bitwise_the_references_where_finite():
    """``ssd_chunked`` with the masked exponent against the reference's
    unmasked form (planted): bitwise outputs and final state."""
    rng = np.random.RandomState(1)
    Bx, Lx, H, P, G, N = 2, 64, 4, 8, 1, 16
    x = torch.as_tensor(rng.randn(Bx, Lx, H, P).astype(np.float32))
    dt = torch.as_tensor(rng.uniform(0.01, 0.2, (Bx, Lx, H))
                         .astype(np.float32))
    a = -torch.as_tensor(np.linspace(1, 16, H).astype(np.float32))
    b = torch.as_tensor(rng.randn(Bx, Lx, G, N).astype(np.float32))
    c = torch.as_tensor(rng.randn(Bx, Lx, G, N).astype(np.float32))
    y, h = mamba2.ssd_chunked(x, dt, a, b, c, 16)
    with lm_smoke.planted("unmasked exponent"):
        y_ref, h_ref = mamba2.ssd_chunked(x, dt, a, b, c, 16)
    assert torch.equal(y, y_ref) and torch.equal(h, h_ref)
    jy, jh = jmamba.ssd_chunked(*(jnp.asarray(t.numpy())
                                  for t in (x, dt, a, b, c)), 16)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)


def test_mamba2_smoke_config_gradients_are_finite_and_match():
    """At the smoke config (chunk 16) both packages' gradients are finite,
    and they agree."""
    jcfg, tcfg, _, tp, b, jl, jg = _arch("mamba2_130m")
    assert tcfg.chunk == 16
    assert all(np.isfinite(np.asarray(g)).all() for g in jax.tree.leaves(jg))
    _, grads = port_loss_and_grads(tcfg, tp, torch_batch(b))
    check_grads(grads, jg, "mamba2 chunk 16")
