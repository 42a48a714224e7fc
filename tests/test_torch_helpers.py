"""The reference's remaining public helpers on the port, against the JAX
package: ``updater.last_write_wins_sorted`` (the O(B log B) winner mask),
``updater.commit_scalar`` and ``attention.sat_attention`` (the SAT
composition the reference's seed oracle calls), with the cosine and the
LUT encoders.

Winner masks and commits are exact (equal); ``sat_attention``'s fp32
products agree to rtol = atol = 1e-5, as a step does in
tests/test_torch_trajectory.py. Inputs come from numpy seeds; weights
cross over through numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention as jattn
from repro.core import time_encode as jte
from repro.core import updater as jupd

from repro_torch.core import attention, updater

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _ids_valid(seed, n, n_ids):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, n_ids, size=n).astype(np.int32),
            rng.rand(n) < 0.7)


@pytest.mark.parametrize("seed", range(12))
def test_last_write_wins_sorted_equals_the_quadratic_and_the_references(
        seed):
    """Random ids (few distinct, so groups repeat) and valid masks, with
    array order and with the engine's interleaved chronological order:
    the sorted mask equals the port's O(B^2) mask and the reference's
    sorted one."""
    n = 1 + seed * 7
    ids, valid = _ids_valid(seed, n, max(1, n // 3))
    for order in (None, np.random.RandomState(seed).permutation(n)):
        t_order = None if order is None else torch.as_tensor(order)
        j_order = None if order is None else jnp.asarray(order)
        got = updater.last_write_wins_sorted(
            torch.as_tensor(ids), torch.as_tensor(valid), t_order)
        quad = updater.last_write_wins(torch.as_tensor(ids),
                                       torch.as_tensor(valid), t_order)
        want = jupd.last_write_wins_sorted(jnp.asarray(ids),
                                           jnp.asarray(valid), j_order)
        np.testing.assert_array_equal(got.numpy(), quad.numpy())
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_last_write_wins_sorted_defaults_and_interleave():
    ids = torch.tensor([3, 3, 3, 1, 1, 2], dtype=torch.int32)
    np.testing.assert_array_equal(
        updater.last_write_wins_sorted(ids).numpy(),
        [False, False, True, False, True, True])
    B = 5
    src, dst = np.array([1, 2, 1, 4, 2]), np.array([2, 1, 3, 1, 9])
    vids = np.concatenate([src, dst]).astype(np.int32)
    valid = np.arange(2 * B) % B < 4
    order = updater.interleave_order(B, "cpu")
    got = updater.last_write_wins_sorted(torch.as_tensor(vids),
                                         torch.as_tensor(valid), order)
    want = jupd.last_write_wins_sorted(jnp.asarray(vids), jnp.asarray(valid),
                                       jupd.interleave_order(B))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.bool_])
def test_commit_scalar_equals_the_references(dtype):
    rng = np.random.RandomState(0)
    V, n = 20, 30
    table = (rng.randn(V) * 10).astype(dtype)
    ids, valid = _ids_valid(1, n, V)
    vals = (rng.randn(n) * 10).astype(np.float32)
    w = updater.last_write_wins(torch.as_tensor(ids), torch.as_tensor(valid))
    got = updater.commit_scalar(torch.as_tensor(table), torch.as_tensor(ids),
                                torch.as_tensor(vals), w)
    want = jupd.commit_scalar(jnp.asarray(table), jnp.asarray(ids),
                              jnp.asarray(vals), jnp.asarray(w.numpy()))
    assert got.dtype == torch.as_tensor(table).dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_commit_scalar_losers_untouched():
    ids = torch.tensor([0, 0], dtype=torch.int32)
    w = updater.last_write_wins(ids)
    out = updater.commit_scalar(torch.tensor([1.0, 2.0, 3.0]), ids,
                                torch.tensor([10.0, 20.0]), w)
    np.testing.assert_array_equal(out.numpy(), [20.0, 2.0, 3.0])


def _t(tree):
    return jax.tree.map(lambda x: torch.as_tensor(np.array(x)), tree)


@pytest.mark.parametrize("encoder", ["cosine", "lut"])
@pytest.mark.parametrize("prune_k,f_feat", [(4, 0), (None, 0), (3, 6)])
def test_sat_attention_equals_the_references(encoder, prune_k, f_feat):
    """Pre-gathered (B, m_r) neighbour buffers with invalid slots and an
    all-invalid row; the logits, the kept slots' softmax, the cosine
    encoding or the folded LUT, and the output transform."""
    B, m_r, f_mem, f_edge, f_time, f_emb = 9, 10, 8, 5, 8, 8
    cfg = jattn.AttnConfig(f_mem=f_mem, f_feat=f_feat, f_edge=f_edge,
                           f_time=f_time, f_emb=f_emb, m_r=m_r,
                           prune_k=prune_k)
    jp = jattn.init_sat(jax.random.key(3), cfg)
    jp["a"] = jax.random.normal(jax.random.key(4), (m_r,))
    tcfg = jte.TimeEncoderConfig(dim=f_time, n_entries=16)
    rng = np.random.RandomState(5)
    dt_samples = rng.exponential(300.0, 500).astype(np.float32)
    jtime = (jte.init_cosine(jax.random.key(6), tcfg) if encoder == "cosine"
             else jte.init_lut(jax.random.key(6), tcfg,
                               dt_samples=dt_samples))
    s_self = rng.randn(B, f_mem).astype(np.float32)
    f_self = rng.randn(B, f_feat).astype(np.float32) if f_feat else None
    s_nbr = rng.randn(B, m_r, f_mem).astype(np.float32)
    e_nbr = rng.randn(B, m_r, f_edge).astype(np.float32)
    dt = rng.exponential(300.0, (B, m_r)).astype(np.float32)
    valid = rng.rand(B, m_r) < 0.6
    valid[0] = False
    args = (s_self, f_self, s_nbr, e_nbr, dt, valid)

    h, logits = attention.sat_attention(
        _t(jp), attention.AttnConfig(**cfg.asdict()), _t(jtime),
        *(None if a is None else torch.as_tensor(a) for a in args),
        encoder=encoder)
    jh, jlogits = jattn.sat_attention(
        jp, cfg, jtime, *(None if a is None else jnp.asarray(a)
                          for a in args), encoder=encoder)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
