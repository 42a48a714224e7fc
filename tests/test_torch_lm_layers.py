"""The port's language-model layers against the JAX package's: norms, rope,
attention (full, chunked, windowed, cross, cached), decode attention on full
and ring caches, both positional-pruned decodes, MLPs, the MoE router,
dispatch and FFN, the SSD scan and causal conv, and the RG-LRU.

Inputs come from a numpy seed; weights are the reference's own init,
carried across through numpy. Everything is fp32 unless a test says
otherwise; integer tables (dispatch, keep, rank, pos, k_pos) must be equal.
``TOL`` (rtol = atol = 1e-5): the same fp32 ops, summed in another order
by another BLAS.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import mamba2 as JM2
from repro.models import moe as JM
from repro.models import rglru as JR
from repro.serving import lm_serve as jserve

from repro_torch import convert
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.serving import lm_serve

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return convert.params_from_reference(_np(tree), "cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **tol)


def _attn(seed=0, **kw):
    cfg = dict(d_model=32, n_heads=4, n_kv_heads=2, d_head=8)
    cfg.update(kw)
    jcfg, tcfg = JL.AttnCfg(**cfg), L.AttnCfg(**cfg)
    jp = JL.init_attention(jax.random.key(seed), jcfg)
    return jcfg, tcfg, jp, _t(jp)


def _x(shape, seed=1, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# ---------------------------------------------------------------------------
# norms, rope, mlp
# ---------------------------------------------------------------------------


def test_rmsnorm_and_layernorm_match_reference():
    x = _x((3, 5, 16), scale=3.0)
    rng = np.random.RandomState(2)
    p = {"scale": rng.randn(16).astype(np.float32)}
    _close(L.rmsnorm(_t(p), torch.as_tensor(x)),
           JL.rmsnorm(p, jnp.asarray(x)))
    p = {"scale": rng.randn(16).astype(np.float32),
         "bias": rng.randn(16).astype(np.float32)}
    _close(L.layernorm(_t(p), torch.as_tensor(x)),
           JL.layernorm(p, jnp.asarray(x)))


@pytest.mark.parametrize("theta,scaling", [(10_000.0, 1.0),
                                           (1_000_000.0, 8.0)])
def test_rope_matches_reference(theta, scaling):
    x = _x((2, 12, 3, 16))
    pos = np.arange(12, dtype=np.int32) + 5
    _close(L.rope(torch.as_tensor(x), torch.as_tensor(pos), theta=theta,
                  scaling=scaling),
           JL.rope(jnp.asarray(x), jnp.asarray(pos), theta=theta,
                   scaling=scaling))


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True),
                                       ("gelu", False)])
def test_mlp_matches_reference(act, gated):
    jp = JL.init_mlp(jax.random.key(3), 16, 24, gated=gated)
    x = _x((2, 5, 16), scale=2.0)
    _close(L.mlp(_t(jp), torch.as_tensor(x), act=act),
           JL.mlp(jp, jnp.asarray(x), act=act))


def test_gelu_is_the_tanh_form():
    x = torch.linspace(-4, 4, 101)
    _close(L.gelu(x), jax.nn.gelu(jnp.asarray(x.numpy()), approximate=True))
    assert (L.gelu(x) - torch.nn.functional.gelu(x)).abs().max() > 1e-5


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window,softcap,qk_norm,kv",
                         [(None, None, False, 2), (None, 30.0, True, 1),
                          (8, None, False, 2), (24, None, True, 4)])
def test_attention_and_chunked_match_reference(window, softcap, qk_norm, kv):
    jcfg, tcfg, jp, tp = _attn(window=window, softcap=softcap,
                               qk_norm=qk_norm, n_kv_heads=kv)
    x = _x((2, 40, 32))
    pos = np.arange(40, dtype=np.int32)
    want, _ = jax.jit(lambda p, a, b: JL.attention(p, jcfg, a, b))(
        jp, jnp.asarray(x), jnp.asarray(pos))
    got, _ = L.attention(tp, tcfg, torch.as_tensor(x), torch.as_tensor(pos))
    _close(got, want)
    # 40 rows in q-blocks of 16 and k-blocks of 16: padded both ways
    jch = jax.jit(lambda p, a, b: JL.chunked_attention(
        p, jcfg, a, b, q_block=16, k_block=16))(jp, jnp.asarray(x),
                                                jnp.asarray(pos))
    ch = L.chunked_attention(tp, tcfg, torch.as_tensor(x),
                             torch.as_tensor(pos), q_block=16, k_block=16)
    _close(ch, jch)
    _close(ch, got, dict(rtol=1e-4, atol=1e-5))   # the online softmax


def test_cross_attention_with_biases_matches_reference():
    jcfg, tcfg, jp, _ = _attn(use_rope=False, bias=True)
    rng = np.random.RandomState(4)
    for k in ("bq", "bv", "bo"):                  # non-zero biases
        jp[k] = jnp.asarray(rng.randn(*jp[k].shape).astype(np.float32))
    tp = _t(jp)
    x, kv_x = _x((2, 10, 32)), _x((2, 24, 32), seed=5)
    pos, kpos = np.arange(10, dtype=np.int32), np.arange(24, dtype=np.int32)
    want, _ = JL.attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                           kv_x=jnp.asarray(kv_x),
                           kv_positions=jnp.asarray(kpos), causal=False)
    got, _ = L.attention(tp, tcfg, torch.as_tensor(x), torch.as_tensor(pos),
                         kv_x=torch.as_tensor(kv_x),
                         kv_positions=torch.as_tensor(kpos), causal=False)
    _close(got, want)
    want = JL.chunked_attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                kv_x=jnp.asarray(kv_x),
                                kv_positions=jnp.asarray(kpos),
                                causal=False, q_block=4, k_block=16)
    got = L.chunked_attention(tp, tcfg, torch.as_tensor(x),
                              torch.as_tensor(pos),
                              kv_x=torch.as_tensor(kv_x),
                              kv_positions=torch.as_tensor(kpos),
                              causal=False, q_block=4, k_block=16)
    _close(got, want)


def test_attention_with_cache_appends_in_place_like_reference():
    """Chunked prefill through ``attention(cache=...)``: two chunks of 6
    tokens into a 16-slot cache."""
    jcfg, tcfg, jp, tp = _attn()
    x = _x((2, 12, 32))
    jc = JL.init_kv_cache(2, 16, jcfg, dtype=jnp.float32)
    tc = convert.params_from_reference(_np(jc), "cpu")
    for s in (slice(0, 6), slice(6, 12)):
        pos = np.arange(s.start, s.stop, dtype=np.int32)
        want, jc = JL.attention(jp, jcfg, jnp.asarray(x[:, s]),
                                jnp.asarray(pos), cache=jc)
        got, tc2 = L.attention(tp, tcfg, torch.as_tensor(x[:, s]),
                               torch.as_tensor(pos), cache=tc)
        assert tc2 is tc                           # written in place
        _close(got, want)
    for k in ("k", "v"):
        _close(tc[k], jc[k])
    assert int(tc["pos"]) == int(jc["pos"]) == 12


def _decode_both(jcfg, tcfg, jp, tp, jc, steps, seed=6, fn=None,
                 jfn=None):
    tc = convert.params_from_reference(_np(jc), "cpu")
    xs = _x((steps, 2, 1, 32), seed=seed)
    fn = fn or (lambda x, c: L.decode_attention(tp, tcfg, x, c))
    jfn = jax.jit(jfn or (lambda x, c: JL.decode_attention(jp, jcfg, x, c)))
    for t in range(steps):
        want, jc = jfn(jnp.asarray(xs[t]), jc)
        got, tc = fn(torch.as_tensor(xs[t]), tc)
        _close(got, want)
    return tc, jc


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_decode_attention_on_a_full_cache_matches_reference(softcap):
    jcfg, tcfg, jp, tp = _attn(softcap=softcap, qk_norm=True)
    jc = JL.init_kv_cache(2, 12, jcfg, dtype=jnp.float32)
    tc, jc = _decode_both(jcfg, tcfg, jp, tp, jc, 9)
    for k in ("k", "v"):
        _close(tc[k], jc[k])
    assert int(tc["pos"]) == int(jc["pos"]) == 9


def test_decode_attention_on_a_wrapping_ring_cache_matches_reference():
    """A window of 6 and 15 tokens: the ring wraps twice."""
    jcfg, tcfg, jp, tp = _attn(window=6)
    jc = JL.init_ring_cache(2, 6, jcfg, dtype=jnp.float32)
    tc, jc = _decode_both(jcfg, tcfg, jp, tp, jc, 15)
    for k in ("k", "v"):
        _close(tc[k], jc[k])
    np.testing.assert_array_equal(tc["k_pos"].numpy(), np.asarray(jc["k_pos"]))
    assert int(tc["pos"]) == int(jc["pos"]) == 15
    assert tc["k_pos"].dtype == torch.int32 and tc["pos"].dtype == torch.int32


def test_decode_attention_on_bf16_caches_with_and_without_upcast():
    """bf16 caches: the default upcast path and §Perf O4's (q and the
    weights rounded to bf16, fp32 accumulation). Logits within
    BF16_TOL = rtol = atol = 1e-2 (a bf16 ulp is 2^-8 of the value, and a
    1-ulp difference before a rounding can move one), caches equal to the
    bf16 rounding of nearly equal values (one bf16 ulp)."""
    tol = dict(rtol=1e-2, atol=1e-2)
    for upcast in (True, False):
        jcfg, tcfg, jp, tp = _attn(cache_upcast=upcast)
        jc = JL.init_kv_cache(2, 10, jcfg)             # bf16
        tc = convert.params_from_reference(_np(jc), "cpu")
        assert tc["k"].dtype == torch.bfloat16
        xs = _x((7, 2, 1, 32), seed=7)
        jdecode = jax.jit(lambda p, x, c: JL.decode_attention(p, jcfg, x, c))
        for t in range(7):
            want, jc = jdecode(jp, jnp.asarray(xs[t]), jc)
            got, tc = L.decode_attention(tp, tcfg, torch.as_tensor(xs[t]), tc)
            _close(got, want, tol)
        back = convert.params_to_numpy(tc)
        for k in ("k", "v"):
            _close(back[k], np.asarray(jc[k], np.float32),
                   dict(rtol=2 ** -7, atol=1e-6))


@pytest.mark.parametrize("keep", [4, 16])
def test_pruned_decode_attention_matches_reference(keep):
    """keep 4 of 12 slots, and keep 16 > 12 (every slot, the surplus -inf
    ties masked)."""
    jcfg, tcfg, jp, tp = _attn(qk_norm=True)
    jc = JL.init_kv_cache(2, 12, jcfg, dtype=jnp.float32)
    tc, jc = _decode_both(
        jcfg, tcfg, jp, tp, jc, 10,
        fn=lambda x, c: L.pruned_decode_attention(tp, tcfg, x, c,
                                                  min(keep, 12)),
        jfn=lambda x, c: JL.pruned_decode_attention(jp, jcfg, x, c,
                                                    min(keep, 12)))
    _close(tc["k"], jc["k"])
    assert int(tc["pos"]) == int(jc["pos"]) == 10


def test_serving_pruned_decode_attention_matches_reference():
    jcfg, tcfg, jp, tp = _attn()
    jpp = jserve.init_kv_prune(jcfg.n_kv_heads)
    tpp = lm_serve.init_kv_prune(tcfg.n_kv_heads, "cpu")
    jc = JL.init_kv_cache(2, 12, jcfg, dtype=jnp.float32)
    tc, jc = _decode_both(
        jcfg, tcfg, jp, tp, jc, 10,
        fn=lambda x, c: lm_serve.pruned_decode_attention(tp, tcfg, x, c,
                                                         tpp, 5),
        jfn=lambda x, c: jserve.pruned_decode_attention(jp, jcfg, x, c,
                                                        jpp, 5))
    _close(tc["v"], jc["v"])
    k_pos = np.array([0, 3, 7, -1], np.int32)
    _close(lm_serve.kv_prune_scores(tpp, torch.as_tensor(k_pos),
                                    torch.tensor(7), 2),
           jserve.kv_prune_scores(jpp, jnp.asarray(k_pos), jnp.asarray(7), 2))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe(E=4, d=16, f=24, seed=0):
    jp = JM.init_moe(jax.random.key(seed), d, f, E)
    return jp, _t(jp)


def test_route_and_dispatch_tables_equal_reference():
    jp, tp = _moe()
    x = _x((64, 16))                 # continuous logits: no ties
    jidx, jprobs = jax.jit(lambda r, a: JM.route(r, a, 2))(jp["router"],
                                                          jnp.asarray(x))
    idx, probs = M.route(tp["router"], torch.as_tensor(x), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(probs, jprobs)
    for cap in (8, 24, 128):          # drops at 8 and 24
        want = jax.jit(lambda i: JM.build_dispatch(i, 4, cap))(jidx)
        got = M.build_dispatch(idx, 4, cap)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert got[0].dtype == torch.int32 and got[2].dtype == torch.int32


@pytest.mark.parametrize("act,k", [("silu", 2), ("gelu", 1)])
def test_moe_ffn_matches_reference_and_dense_oracle(act, k):
    jp, tp = _moe()
    x = _x((48, 16))
    want = jax.jit(lambda p, a: JM.moe_ffn(p, a, k, act=act))(
        jp, jnp.asarray(x))
    got = M.moe_ffn(tp, torch.as_tensor(x), k, act=act)
    _close(got, want)
    # ample capacity (C = 128 > 48 * k): the dense oracle
    _close(got, M.moe_ffn_ref(tp, torch.as_tensor(x), k, act=act))
    _close(M.moe_ffn_ref(tp, torch.as_tensor(x), k, act=act),
           jax.jit(lambda p, a: JM.moe_ffn_ref(p, a, k, act=act))(
               jp, jnp.asarray(x)))


def test_moe_ffn_with_capacity_drops_matches_reference():
    """A router biased to expert 0 over 512 tokens: expert 0 is picked by
    every token, beyond its capacity of 384, so slots are dropped."""
    jp, _ = _moe(E=4, d=8, f=16, seed=2)
    router = np.asarray(jp["router"]).copy()
    router[:, 0] = 0.0
    router[0, 0] = 50.0               # expert 0's logit: 50 x[:, 0] >= 25
    jp["router"] = jnp.asarray(router)
    x = _x((512, 8), seed=3)
    x[:, 0] = np.abs(x[:, 0]) + 0.5
    tp = _t(jp)
    _, keep, _ = M.build_dispatch(M.route(tp["router"], torch.as_tensor(x),
                                          2)[0], 4, M.capacity(512, 4, 2))
    assert not bool(keep.all())
    want = jax.jit(lambda p, a: JM.moe_ffn(p, a, 2))(jp, jnp.asarray(x))
    got = M.moe_ffn(tp, torch.as_tensor(x), 2)
    _close(got, want)
    assert float((got - M.moe_ffn_ref(tp, torch.as_tensor(x), 2))
                 .abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# SSD and the causal conv
# ---------------------------------------------------------------------------


def _ssd_inputs(B=2, Lx=32, H=4, P=8, G=2, N=8, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, Lx, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(B, Lx, H))).astype(np.float32) * 0.5
    a = -np.linspace(0.5, 2.0, H).astype(np.float32)
    b = rng.randn(B, Lx, G, N).astype(np.float32)
    c = rng.randn(B, Lx, G, N).astype(np.float32)
    return x, dt, a, b, c


@pytest.mark.parametrize("chunk", [8, 32])
def test_ssd_chunked_matches_reference_and_recurrence(chunk):
    ins = _ssd_inputs()
    h0 = _x((2, 4, 8, 8), seed=9)
    for init in (None, h0):
        jy, jh = jax.jit(lambda *a: JM2.ssd_chunked(*a[:5], chunk, *a[5:]))(
            *map(jnp.asarray, ins), *([] if init is None
                                      else [jnp.asarray(init)]))
        y, h = M2.ssd_chunked(*map(torch.as_tensor, ins), chunk,
                              None if init is None
                              else torch.as_tensor(init))
        _close(y, jy, dict(rtol=1e-5, atol=2e-5))
        _close(h, jh, dict(rtol=1e-5, atol=2e-5))
    _close(M2.ssd_ref(*map(torch.as_tensor, ins)),
           jax.jit(JM2.ssd_ref)(*map(jnp.asarray, ins)),
           dict(rtol=1e-5, atol=2e-5))
    # the chunked form against the step-by-step recurrence (the reference
    # package's own test tolerance)
    y, _ = M2.ssd_chunked(*map(torch.as_tensor, ins), chunk)
    _close(y, M2.ssd_ref(*map(torch.as_tensor, ins)),
           dict(rtol=1e-3, atol=1e-3))


def test_causal_conv_matches_reference_with_and_without_state():
    x, w, b = _x((2, 9, 6)), _x((4, 6), seed=2), _x((6,), seed=3)
    state = _x((2, 3, 6), seed=4)
    for st in (None, state):
        want, wst = JM2._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b),
                                     None if st is None else jnp.asarray(st))
        got, gst = M2._causal_conv(torch.as_tensor(x), torch.as_tensor(w),
                                   torch.as_tensor(b),
                                   None if st is None
                                   else torch.as_tensor(st))
        _close(got, want)
        _close(gst, wst)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def test_rglru_scan_and_step_match_reference():
    """The step is elementwise and held to TOL. The scan is a sequential
    fp32 loop here and an associative scan in the reference: the products
    associate in another order, so it is held to rtol = atol = 1e-5 over
    40 steps as well (decays in (0, 1) keep the rounding from growing)."""
    jp = JR.init_rglru(jax.random.key(0), 16, 4)
    tp = _t(jp)
    x = _x((2, 40, 16), scale=2.0)
    h0 = _x((2, 16), seed=5)
    for init in (None, h0):
        jy, jh = jax.jit(JR.rglru_scan)(
            jp, jnp.asarray(x), None if init is None else jnp.asarray(init))
        y, h = R.rglru_scan(tp, torch.as_tensor(x),
                            None if init is None else torch.as_tensor(init))
        _close(y, jy)
        _close(h, jh)
    hj, ht = jnp.asarray(h0), torch.as_tensor(h0)
    jstep = jax.jit(JR.rglru_step)
    for t in range(5):
        jy, hj = jstep(jp, jnp.asarray(x[:, t:t + 1]), hj)
        y, ht = R.rglru_step(tp, torch.as_tensor(x[:, t:t + 1]), ht)
        _close(y, jy)
        _close(ht, hj)
