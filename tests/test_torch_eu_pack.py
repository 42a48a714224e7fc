"""The packed weights of the tensor-core SAT Embedding Unit, on the CPU.

``ops.pack_sat_params`` adds ``w_tc`` (W_v, the kv rows as one source) and
``ops.pack_fused_params`` adds ``wv_tc`` (W_v, memory rows then edge rows)
and ``wout_tc`` (W_out, s_upd rows then aggregate rows): the layouts
``rt::tc_tile`` (``kernels/csrc/common.cuh``) streams, built by
``ops.pack_rows_tc``. Per column tile and depth stage, the TF32 high part
and the low part of the stage's rows, each source's rows padded to whole
stages. These tests pin the layouts and the numbers of the 3xTF32
product before any GPU run:

- the layouts unpack to the raw weights, hi + lo within 2^-22 |w| of w;
- rows and columns of padding are exactly 0;
- an emulation of the kernels' arithmetic (the same splits, the products
  over the same padded rows) stays within the kernels' tolerance of
  ``sat_aggregate_plain`` and ``fused_step_plain`` at the main path's
  widths, where a single TF32 pass does not;
- the wrappers refuse a pack of other widths;
- the packer's tile constants are the ones the kernels are built with.

Tolerance: rtol = atol = 1e-5, the one every kernel is held to against its
plain version (tests/test_torch_cuda.py, chip_smoke.py).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
E = 128
# (rows of each source, N): sat_aggregate's kv rows, fused_step's W_v and
# W_out at the main path's widths, f_edge = 0, and ragged small widths
LAYOUTS = [((272,), 100), ((100, 172), 100), ((100, 100), 100),
           ((36, 0), 36), ((35, 7), 9), ((1,), 1), ((5, 3), 200)]
DEPTHS = [(ops.EU_DEPTH, ops.EU_COLS), (ops.OUT_DEPTH, ops.OUT_COLS)]


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))


def unpack(w_tc):
    """w_tc (NT, S, 2, D, C) -> hi, lo, each (S * D, NT * C): the packed
    depth rows at the padded width."""
    nt, S, _, D, C = w_tc.shape
    hi, lo = w_tc.permute(2, 1, 3, 0, 4).reshape(2, S * D, nt * C)
    return hi, lo


def _offsets(rows, depth):
    """Start row of each source in the packed depth."""
    out, r0 = [], 0
    for r in rows:
        out.append(r0)
        r0 += -(-r // depth) * depth
    return out


@pytest.mark.parametrize("depth,cols", DEPTHS)
@pytest.mark.parametrize("rows,N", LAYOUTS)
def test_packed_layout_unpacks_to_the_raw_weights(rows, N, depth, cols):
    rng = np.random.RandomState(0)
    parts = [_rand(rng, r, N) for r in rows]
    w_tc = ops.pack_rows_tc(parts, depth, cols)
    S = sum(-(-r // depth) for r in rows)
    assert w_tc.shape == (-(-N // cols), S, 2, depth, cols)
    assert w_tc.is_contiguous()
    hi, lo = unpack(w_tc)
    for part in (hi, lo):                  # both are TF32 values
        assert not (part.view(torch.int32) & 0x1FFF).any()
    for w, r0 in zip(parts, _offsets(rows, depth)):
        got = hi[r0:r0 + w.shape[0], :N].double() + lo[r0:r0 + w.shape[0],
                                                       :N].double()
        assert ((got - w.double()).abs() <= 2.0 ** -22 * w.abs()).all()


@pytest.mark.parametrize("depth,cols", DEPTHS)
@pytest.mark.parametrize("rows,N", LAYOUTS)
def test_packed_padding_is_exactly_zero(rows, N, depth, cols):
    rng = np.random.RandomState(1)
    parts = [_rand(rng, r, N) + 1.0 for r in rows]
    for part in unpack(ops.pack_rows_tc(parts, depth, cols)):
        live = torch.zeros(part.shape, dtype=torch.bool)
        for r, r0 in zip(rows, _offsets(rows, depth)):
            live[r0:r0 + r, :N] = True
        assert torch.equal(part[~live], torch.zeros(int((~live).sum())))


def test_packs_carry_the_layouts_beside_the_raw_weights():
    rng = np.random.RandomState(2)
    M, Fe, D, F = 100, 172, 100, 372
    w_v, b_v = _rand(rng, M + Fe, D), _rand(rng, D)
    bounds, table = torch.sort(_rand(rng, E - 1)).values, _rand(rng, E, D)
    sat = ops.pack_sat_params(w_v, b_v, bounds, table)
    assert torch.equal(sat["w_v"], w_v)    # the plain version's raw key
    assert torch.equal(sat["w_tc"],
                       ops.pack_rows_tc([w_v], ops.EU_DEPTH, ops.EU_COLS))
    p = _fused_pack(rng, M, Fe, D, F)
    w_out = p["w_out"]
    assert torch.equal(p["wv_tc"], ops.pack_rows_tc(
        [p["w_v"][:M], p["w_v"][M:]], ops.EU_DEPTH, ops.EU_COLS))
    assert torch.equal(p["wout_tc"], ops.pack_rows_tc(
        [w_out[:M], w_out[M:]], ops.OUT_DEPTH, ops.OUT_COLS))


# ---------------------------------------------------------------------------
# the kernels' arithmetic, emulated
# ---------------------------------------------------------------------------


def tc_product(parts, w_tc, depth, N, passes=3):
    """The arithmetic of rt::tc_tile on the CPU: the rows [parts[0] ||
    parts[1] || ...] laid out at the packed depth, split with the same
    rounding, and a_lo b_hi + a_hi b_lo + a_hi b_hi (passes = 3) or
    a_hi b_hi alone (passes = 1)."""
    hi, lo = unpack(w_tc)
    a = torch.zeros((parts[0].shape[0], hi.shape[0]), dtype=torch.float32)
    for x, r0 in zip(parts, _offsets([x.shape[1] for x in parts], depth)):
        a[:, r0:r0 + x.shape[1]] = x
    a_hi, a_lo = ops.tf32_split(a)
    out = a_hi @ hi
    if passes == 3:
        out = a_lo @ hi + a_hi @ lo + out
    return out[:, :N]


def _eu_inputs(rng, R, k, M, Fe, V, n_edges):
    valid = rng.rand(R, k) > 0.3
    valid[0] = False                       # an all-invalid row
    return dict(
        sel_ids=torch.from_numpy(rng.randint(0, V, (R, k)).astype(np.int32)),
        sel_eid=torch.from_numpy(
            rng.randint(0, n_edges, (R, k)).astype(np.int32)),
        hit=torch.from_numpy(np.where(rng.rand(R, k) < 0.4,
                                      rng.randint(0, R, (R, k)),
                                      -1).astype(np.int32)),
        sel_dt=torch.from_numpy(
            (10 ** rng.uniform(0, 7, (R, k))).astype(np.float32)),
        logits=_rand(rng, R, k, scale=3.0), valid=torch.from_numpy(valid),
        memory=_rand(rng, V, M), edge_feats=_rand(rng, n_edges, Fe))


def _fused_pack(rng, M, Fe, D, F):
    bounds = torch.from_numpy(
        np.sort(10 ** rng.uniform(0, 7, E - 1)).astype(np.float32))
    return ops.pack_fused_params(
        dict(w_i=_rand(rng, F, 3 * M, scale=F ** -0.5),
             w_h=_rand(rng, M, 3 * M, scale=M ** -0.5),
             b_i=_rand(rng, 3 * M), b_h=_rand(rng, 3 * M)),
        dict(w_v=_rand(rng, M + Fe, D, scale=(M + Fe) ** -0.5),
             b_v=_rand(rng, D), w_out=_rand(rng, M + D, D,
                                            scale=(M + D) ** -0.5),
             b_out=_rand(rng, D)),
        dict(boundaries=bounds, table=_rand(rng, E, 3 * M)),
        dict(boundaries=bounds, table=_rand(rng, E, D)), F, M, Fe)


R, K, M, FE, D = 400, 4, 100, 172, 100     # the main path's widths


@pytest.mark.parametrize("passes", [3, 1])
def test_3xtf32_sat_aggregate_holds_the_kernel_tolerance(passes):
    rng = np.random.RandomState(3)
    kv = _rand(rng, R, K, M + FE)
    c = _eu_inputs(rng, R, K, M, FE, 10, 10)
    bounds = torch.from_numpy(
        np.sort(10 ** rng.uniform(0, 7, E - 1)).astype(np.float32))
    p = ops.pack_sat_params(_rand(rng, M + FE, D, scale=(M + FE) ** -0.5),
                            _rand(rng, D), bounds, _rand(rng, E, D))
    args = (kv, c["sel_dt"], c["logits"], c["valid"])
    want = ops.sat_aggregate_plain(*args, p["w_v"], p["b_v"], p["bounds"],
                                   p["table"])
    v = tc_product([kv.reshape(R * K, -1)], p["w_tc"], ops.EU_DEPTH, D,
                   passes)
    v = v + ops.lut_encode_plain(c["sel_dt"].reshape(-1), p["bounds"],
                                 p["table"]) + p["b_v"]
    got = ops._softmax_fam_plain(c["logits"], c["valid"], v.reshape(R, K, D))
    if passes == 3:
        torch.testing.assert_close(got, want, **TOL)
    else:                                  # a single TF32 pass: ~3 digits
        assert not torch.allclose(got, want, **TOL)


@pytest.mark.parametrize("passes", [3, 1])
def test_3xtf32_fused_eu_holds_the_kernel_tolerance(passes):
    rng = np.random.RandomState(4)
    V, n_edges, F = 500, 2000, 2 * M + FE
    c = _eu_inputs(rng, R, K, M, FE, V, n_edges)
    p = _fused_pack(rng, M, FE, D, F)
    vids = torch.from_numpy(rng.randint(0, V, R).astype(np.int32))
    dt_mail = torch.from_numpy((10 ** rng.uniform(0, 7, R)).astype(
        np.float32))
    mail_ok = torch.from_numpy(rng.rand(R) > 0.3)
    mail = _rand(rng, V, F)
    want_h, s_upd = ops.fused_step_plain(
        vids, c["sel_ids"], c["sel_eid"], c["hit"], dt_mail, mail_ok,
        c["sel_dt"], c["logits"], c["valid"], c["memory"], mail,
        c["edge_feats"], p)
    hit = c["hit"].long()
    nbr_s = torch.where((hit >= 0)[..., None], s_upd[hit.clamp(min=0)],
                        c["memory"][c["sel_ids"].long()])
    nbr_e = c["edge_feats"][c["sel_eid"].long()]
    v = tc_product([nbr_s.reshape(R * K, M), nbr_e.reshape(R * K, FE)],
                   p["wv_tc"], ops.EU_DEPTH, D, passes)
    v = v + ops.lut_encode_plain(c["sel_dt"].reshape(-1), p["s_bounds"],
                                 p["s_table"]) + p["b_v"]
    agg = ops._softmax_fam_plain(c["logits"], c["valid"], v.reshape(R, K, D))
    h = tc_product([s_upd, agg], p["wout_tc"], ops.OUT_DEPTH, D,
                   passes) + p["b_out"]
    if passes == 3:
        torch.testing.assert_close(h, want_h, **TOL)
    else:                                  # a single TF32 pass: ~3 digits
        assert not torch.allclose(h, want_h, **TOL)


# ---------------------------------------------------------------------------
# the wrappers' checks, and the tile constants
# ---------------------------------------------------------------------------


def _meta(tree):
    return {k: v.to("meta") for k, v in tree.items()}


@pytest.mark.parametrize("swap,error", [
    ("w_tc", "w_tc has shape"),      # packed for kv rows a stage wider
    ("kv", "w_v has shape"),         # kv one wider than the raw W_v
])
def test_sat_aggregate_refuses_a_pack_of_other_widths(swap, error):
    """The CUDA path checks the pack against the inputs' widths before it
    launches (meta tensors stand in for the card)."""
    rng = np.random.RandomState(5)
    B, k, dkv, d = 5, 4, 21, 8
    bounds = torch.sort(_rand(rng, E - 1)).values
    p = _meta(ops.pack_sat_params(_rand(rng, dkv, d), _rand(rng, d), bounds,
                                  _rand(rng, E, d)))
    if swap == "w_tc":
        p["w_tc"] = ops.pack_rows_tc([_rand(rng, dkv + ops.EU_DEPTH, d)],
                                     ops.EU_DEPTH, ops.EU_COLS).to("meta")
    kv = torch.empty((B, k, dkv + (swap == "kv")), device="meta")
    dt = torch.empty((B, k), device="meta")
    valid = torch.empty((B, k), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match=error):
        ops.sat_aggregate(kv, dt, dt, valid, p)


@pytest.mark.parametrize("swap,error", [
    ("wv_tc", "wv_tc has shape"),    # packed for edge rows a stage wider
    ("wout_tc", "wout_tc has shape"),  # packed for aggregate rows likewise
    ("edge_feats", "w_v has shape"),   # f_edge one wider than the raw W_v
])
def test_fused_step_refuses_a_pack_of_other_widths(swap, error):
    rng = np.random.RandomState(6)
    Rs, k, m, fe, d = 5, 4, 8, 5, 8
    f = 2 * m + fe
    p = _meta(_fused_pack(rng, m, fe, d, f))
    if swap == "wv_tc":
        p["wv_tc"] = ops.pack_rows_tc(
            [_rand(rng, m, d), _rand(rng, fe + ops.EU_DEPTH, d)],
            ops.EU_DEPTH, ops.EU_COLS).to("meta")
    if swap == "wout_tc":
        p["wout_tc"] = ops.pack_rows_tc(
            [_rand(rng, m, d), _rand(rng, d + ops.OUT_DEPTH, d)],
            ops.OUT_DEPTH, ops.OUT_COLS).to("meta")

    def t(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    i32, b = torch.int32, torch.bool
    args = (t(Rs, dtype=i32), t(Rs, k, dtype=i32), t(Rs, k, dtype=i32),
            t(Rs, k, dtype=i32), t(Rs), t(Rs, dtype=b), t(Rs, k), t(Rs, k),
            t(Rs, k, dtype=b), t(7, m), t(7, f),
            t(9, fe + (swap == "edge_feats")))
    with pytest.raises(ValueError, match=error):
        ops.fused_step(*args, p)


def test_pack_tiles_match_the_kernels_constants():
    src = (Path(ops.__file__).parent / "csrc" / "common.cuh").read_text()

    def const(name):
        (value,) = re.findall(rf"constexpr int {name} = (\d+);", src)
        return int(value)

    for tile, cols, depth in (("Eu", ops.EU_COLS, ops.EU_DEPTH),
                              ("Out", ops.OUT_COLS, ops.OUT_DEPTH)):
        assert 8 * const(f"k{tile}NTiles") == cols
        assert 8 * const(f"k{tile}Warps") * const(f"k{tile}KSteps") == depth
    assert const("kGruCols") == ops.GRU_COLS
    assert 8 * const("kGruWarps") * const("kGruKSteps") == ops.GRU_DEPTH
