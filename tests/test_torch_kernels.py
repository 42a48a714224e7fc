"""The port's four kernel entry points against the JAX package's kernels.

On the CPU each entry point of ``repro_torch.kernels.ops`` runs its plain
PyTorch version; here it is held against the reference's Pallas kernel run
as the reference's own tests run it on the CPU (interpret mode, through
``repro.kernels.ops``). The cases cover ragged row counts, all-invalid
rows, dt values exactly on and just below bucket boundaries, and winners
redirected to this batch's updated rows (``hit >= 0``).

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py.

Tolerances: the LUT fetch copies table rows, so it must be exact. The
products are fp32 on both sides, summed in other orders: rtol = atol =
1e-5 (the reference's own kernel tests use the same bound).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention as jattn
from repro.core import memory as jmem
from repro.core import time_encode as jte
from repro.kernels import ops as jops

from repro_torch.kernels import ops

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x, device="cpu"):
    return torch.as_tensor(np.array(x), device=device)


def _lut(dim, seed=2):
    lut = jte.init_lut(jax.random.key(seed),
                       jte.TimeEncoderConfig(dim=dim, n_entries=128))
    return np.asarray(lut["boundaries"]), np.asarray(lut["table"])


def _boundary_dts(bounds, n, seed):
    """dt on, just below and between the boundaries, plus 0, negatives and
    values past the last boundary."""
    rng = np.random.RandomState(seed)
    edge = np.concatenate([bounds, np.nextafter(bounds, -np.inf),
                           [0.0, -5.0, bounds[-1] * 3.0]]).astype(np.float32)
    body = (10 ** rng.uniform(0, 7, n)).astype(np.float32)
    return np.concatenate([edge, body])


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def lut_case(n, dim):
    bounds, table = _lut(dim)
    return _boundary_dts(bounds, n, seed=n), bounds, table


def gru_case(n, f_mem, f_edge, seed=0):
    cfg = jmem.GRUConfig(f_mem=f_mem, f_edge=f_edge, f_time=f_mem)
    p = jax.tree.map(np.asarray, jmem.init_gru(jax.random.key(seed), cfg))
    p["b_i"] = np.random.RandomState(seed).randn(3 * f_mem).astype(np.float32)
    p["b_h"] = np.random.RandomState(seed + 1).randn(3 * f_mem).astype(
        np.float32)
    rng = np.random.RandomState(n + f_mem)
    mail = rng.randn(n, cfg.f_mail_raw).astype(np.float32)
    s = rng.randn(n, f_mem).astype(np.float32)
    extra = rng.randn(n, 3 * f_mem).astype(np.float32)
    w_i = p["w_i"][:cfg.f_mail_raw]
    return mail, s, extra, w_i, p["w_h"], p["b_i"], p["b_h"]


def sat_case(B, k, dkv, d, seed=0):
    rng = np.random.RandomState(seed)
    bounds, table = _lut(d, seed=seed + 3)
    kv = rng.randn(B, k, dkv).astype(np.float32)
    dt = _boundary_dts(bounds, B * k, seed)[:B * k].reshape(B, k)
    logits = (3 * rng.randn(B, k)).astype(np.float32)
    valid = rng.rand(B, k) > 0.3
    valid[0] = False                       # an all-invalid row
    valid[-1] = True
    w_v = (rng.randn(dkv, d) / np.sqrt(dkv)).astype(np.float32)
    b_v = rng.randn(d).astype(np.float32)
    return kv, dt.astype(np.float32), logits, valid, w_v, b_v, bounds, table


def fused_case(R=23, k=4, f_mem=16, f_edge=24, V=40, n_edges=60, seed=0):
    """A batch of R rows over V vertices. Some winners are redirected to
    rows of this batch (hit >= 0), some rows have no valid winner, some
    have no mail."""
    rng = np.random.RandomState(seed)
    key = jax.random.key(seed)
    gcfg = jmem.GRUConfig(f_mem=f_mem, f_edge=f_edge, f_time=f_mem)
    acfg = jattn.AttnConfig(f_mem=f_mem, f_edge=f_edge, f_time=f_mem,
                            f_emb=f_mem, m_r=10)
    gru_p = jmem.init_gru(jax.random.fold_in(key, 1), gcfg)
    attn_p = jattn.init_sat(jax.random.fold_in(key, 2), acfg)
    gru_p = {**gru_p, "b_i": jnp.asarray(rng.randn(3 * f_mem), jnp.float32)}
    attn_p = {**attn_p, "b_v": jnp.asarray(rng.randn(f_mem), jnp.float32),
              "b_out": jnp.asarray(rng.randn(f_mem), jnp.float32)}
    time_p = jte.init_lut(jax.random.fold_in(key, 3),
                          jte.TimeEncoderConfig(dim=f_mem, n_entries=128))
    dkv = f_mem + f_edge
    folded_gru = jte.fold_projection(time_p, gru_p["w_i"][gcfg.f_mail_raw:])
    folded_attn = jte.fold_projection(time_p, attn_p["w_v"][dkv:])
    vids = rng.randint(0, V, R).astype(np.int32)
    sel_ids = rng.randint(0, V, (R, k)).astype(np.int32)
    sel_eid = rng.randint(0, n_edges, (R, k)).astype(np.int32)
    hit = np.where(rng.rand(R, k) < 0.4, rng.randint(0, R, (R, k)),
                   -1).astype(np.int32)
    bounds = np.asarray(time_p["boundaries"])
    dt_mail = _boundary_dts(bounds, R, seed)[-R:].astype(np.float32)
    mail_ok = rng.rand(R) > 0.3
    sel_dt = _boundary_dts(bounds, R * k, seed + 1)[:R * k].reshape(R, k)
    sel_logits = (3 * rng.randn(R, k)).astype(np.float32)
    sel_valid = rng.rand(R, k) > 0.3
    sel_valid[1] = False
    memory = rng.randn(V, f_mem).astype(np.float32)
    mail = rng.randn(V, gcfg.f_mail_raw).astype(np.float32)
    edge_feats = rng.randn(n_edges, f_edge).astype(np.float32)
    arrays = (vids, sel_ids, sel_eid, hit, dt_mail, mail_ok,
              sel_dt.astype(np.float32), sel_logits, sel_valid, memory, mail,
              edge_feats)
    params = (gru_p, attn_p, folded_gru, folded_attn, gcfg.f_mail_raw, f_mem,
              f_edge)
    return arrays, params


def _pack_fused(params, device):
    gru_p, attn_p, fg, fa, f_mail_raw, f_mem, f_edge = params
    def t(tree):                      # the arrays; SAT's empty "feat" dropped
        return {k: _t(v, device) for k, v in tree.items()
                if not isinstance(v, dict)}

    return ops.pack_fused_params(t(gru_p), t(attn_p), t(fg), t(fa),
                                 f_mail_raw, f_mem, f_edge)


# ---------------------------------------------------------------------------
# plain versions (CPU) vs the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,dim", [(1, 16), (300, 24), (517, 100)])
def test_lut_encode_matches_jax_kernel(n, dim):
    dt, bounds, table = lut_case(n, dim)
    want = jops.lut_encode(jnp.asarray(dt),
                           jops.pad_lut_params(jnp.asarray(bounds),
                                               jnp.asarray(table)))
    got = ops.lut_encode(_t(dt), ops.pack_lut_params(_t(bounds), _t(table)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and against the core LUT encoder on the E-1 interior boundaries
    core = jte.lut_encode({"boundaries": jnp.asarray(bounds),
                           "table": jnp.asarray(table)}, jnp.asarray(dt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(core))


@pytest.mark.parametrize("n,f_mem,f_edge", [(1, 16, 24), (37, 16, 24),
                                            (130, 32, 0)])
@pytest.mark.parametrize("with_extra", [True, False])
def test_gru_cell_matches_jax_kernel(n, f_mem, f_edge, with_extra):
    mail, s, extra, w_i, w_h, b_i, b_h = gru_case(n, f_mem, f_edge)
    jpacked = jops.pad_gru_params(
        {"w_i": jnp.asarray(w_i), "w_h": jnp.asarray(w_h),
         "b_i": jnp.asarray(b_i), "b_h": jnp.asarray(b_h)},
        w_i.shape[0], f_mem)
    want = jops.gru_cell(jnp.asarray(mail), jnp.asarray(s), jpacked,
                         extra=jnp.asarray(extra) if with_extra else None)
    got = ops.gru_cell(_t(mail), _t(s),
                       ops.pack_gru_params(_t(w_i), _t(w_h), _t(b_i),
                                           _t(b_h)),
                       extra=_t(extra) if with_extra else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("B,k,dkv,d", [(1, 4, 40, 16), (33, 4, 40, 16),
                                       (20, 10, 24, 36), (9, 2, 188, 16)])
def test_sat_aggregate_matches_jax_kernel(B, k, dkv, d):
    kv, dt, logits, valid, w_v, b_v, bounds, table = sat_case(B, k, dkv, d)
    want = jops.sat_aggregate(
        jnp.asarray(kv), jnp.asarray(dt), jnp.asarray(logits),
        jnp.asarray(valid),
        jops.pad_sat_params(jnp.asarray(w_v), jnp.asarray(b_v),
                            jnp.asarray(bounds), jnp.asarray(table)))
    got = ops.sat_aggregate(_t(kv), _t(dt), _t(logits), _t(valid),
                            ops.pack_sat_params(_t(w_v), _t(b_v), _t(bounds),
                                                _t(table)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if not valid[0].any():
        assert not got[0].any()            # all-invalid row gives zeros


@pytest.mark.parametrize("R,k,f_edge", [(23, 4, 24), (8, 2, 0), (5, 10, 24)])
def test_fused_step_matches_jax_kernel(R, k, f_edge):
    arrays, params = fused_case(R=R, k=k, f_edge=f_edge)
    gru_p, attn_p, fg, fa, f_mail_raw, f_mem, _ = params
    jpacked = jops.pad_fused_params(gru_p, attn_p, fg, fa, f_mail_raw, f_mem,
                                    f_edge)
    want_h, want_s = jops.fused_step(*map(jnp.asarray, arrays), jpacked)
    got_h, got_s = ops.fused_step(*map(_t, arrays),
                                  _pack_fused(params, "cpu"))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    assert (arrays[3] >= 0).any()          # the case has redirected winners


def test_cpu_entry_points_launch_nothing():
    ops.reset_launch_counts()
    dt, bounds, table = lut_case(7, 16)
    ops.lut_encode(_t(dt), ops.pack_lut_params(_t(bounds), _t(table)))
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCHES, 0)
