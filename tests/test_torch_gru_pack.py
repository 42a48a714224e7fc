"""The packed GRU weights of the tensor-core GRU update, on the CPU.

``ops.pack_gru_params`` adds ``w_tc``, the layout ``rt::gru_update``
(``kernels/csrc/common.cuh``) streams: per 8-column tile and 32-deep
stage, the TF32 high part and the low part of the [r | z | n] weights,
mail rows (W_i) first, memory rows (W_h) after, each padded to a whole
stage. These tests pin the layout and the numbers of the 3xTF32 product
before any GPU run:

- the layout unpacks to the raw weights, hi + lo within 2^-22 |w| of w;
- rows and columns past F and M are exactly 0;
- an emulation of the kernel's arithmetic (the same splits and the same
  four accumulators) stays within the kernels' tolerance of the plain fp32
  GRU at the main path's widths, where a single TF32 pass does not.

Tolerance: rtol = atol = 1e-5, the one every kernel is held to against its
plain version (tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = [(372, 100), (21, 8), (77, 36), (32, 32), (1, 1)]   # (F, M)


def _weights(F, M, seed=0):
    rng = np.random.RandomState(seed)
    w_i = (rng.randn(F, 3 * M) / np.sqrt(F)).astype(np.float32)
    w_h = (rng.randn(M, 3 * M) / np.sqrt(M)).astype(np.float32)
    b_i, b_h = (rng.randn(2, 3 * M)).astype(np.float32)
    return tuple(torch.from_numpy(x) for x in (w_i, w_h, b_i, b_h))


def unpack(w_tc):
    """w_tc (NT, S, 2, D, 3 * C) -> hi, lo, each (S * D, 3, NT * C): the
    packed depth rows with the gate blocks at the padded width."""
    nt, S, _, D, c3 = w_tc.shape
    C = c3 // 3
    w = w_tc.reshape(nt, S, 2, D, 3, C).permute(2, 1, 3, 4, 0, 5)
    hi, lo = w.reshape(2, S * D, 3, nt * C)
    return hi, lo


def test_tf32_round_is_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                       # TF32 keeps 10 mantissa bits
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2),
                      one + ulp / 2 - 2 ** -23, one + 1.5 * ulp, 3.0, 0.0,
                      -0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0,
                         0.0, -0.0], dtype=torch.float32)
    got = ops.tf32_round(x)
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))
    assert not (got.view(torch.int32) & 0x1FFF).any()


@pytest.mark.parametrize("F,M", SHAPES)
def test_packed_layout_unpacks_to_the_raw_weights(F, M):
    w_i, w_h, b_i, b_h = _weights(F, M)
    p = ops.pack_gru_params(w_i, w_h, b_i, b_h)
    for name, t in (("w_i", w_i), ("w_h", w_h), ("b_i", b_i), ("b_h", b_h)):
        assert torch.equal(p[name], t)     # the plain versions' raw keys
    sf, sm = ops.gru_stages(F, M)
    nt = -(-M // ops.GRU_COLS)
    assert p["w_tc"].shape == (nt, sf + sm, 2, ops.GRU_DEPTH,
                               3 * ops.GRU_COLS)
    assert p["w_tc"].is_contiguous()
    hi, lo = unpack(p["w_tc"])
    for part in (hi, lo):                  # both are TF32 values
        assert not (part.view(torch.int32) & 0x1FFF).any()
    m0 = sf * ops.GRU_DEPTH
    for w, rows in ((w_i, slice(0, F)), (w_h, slice(m0, m0 + M))):
        want = w.reshape(-1, 3, M).double()
        got = (hi[rows, :, :M].double() + lo[rows, :, :M].double())
        assert ((got - want).abs() <= 2.0 ** -22 * want.abs()).all()


@pytest.mark.parametrize("F,M", SHAPES)
def test_packed_padding_is_exactly_zero(F, M):
    w_i, w_h, b_i, b_h = _weights(F, M, seed=1)
    w_tc = ops.pack_gru_params(w_i + 1.0, w_h + 1.0, b_i, b_h)["w_tc"]
    m0 = ops.gru_stages(F, M)[0] * ops.GRU_DEPTH
    for part in unpack(w_tc):
        live = torch.zeros(part.shape, dtype=torch.bool)
        live[:F, :, :M] = True
        live[m0:m0 + M, :, :M] = True
        assert torch.equal(part[~live], torch.zeros(int((~live).sum())))


def gru_update_3xtf32(mail, s, packed, extra=None, passes=3):
    """The arithmetic of rt::gru_update on the CPU: the activations split
    with the same rounding, the products a_lo b_hi + a_hi b_lo + a_hi b_hi
    (passes = 3) or a_hi b_hi alone (passes = 1), four accumulators (r and
    z over [mail || s], gi_n over mail, gh_n over s), then the gate tail."""
    n, F = mail.shape
    M = s.shape[1]
    hi, lo = unpack(packed["w_tc"])
    m0 = ops.gru_stages(F, M)[0] * ops.GRU_DEPTH
    a = torch.zeros((n, hi.shape[0]), dtype=torch.float32)
    a[:, :F] = mail
    a[:, m0:m0 + M] = s
    a_hi, a_lo = ops.tf32_split(a)

    def prod(rows, q):
        w_hi, w_lo = hi[rows, q, :M], lo[rows, q, :M]
        out = a_hi[:, rows] @ w_hi
        if passes == 3:
            out = a_lo[:, rows] @ w_hi + a_hi[:, rows] @ w_lo + out
        return out

    every, mail_rows, mem_rows = slice(None), slice(0, m0), slice(m0, None)
    acc_r, acc_z = prod(every, 0), prod(every, 1)
    gi_n, gh_n = prod(mail_rows, 2), prod(mem_rows, 2)
    b_i, b_h = packed["b_i"].reshape(3, M), packed["b_h"].reshape(3, M)
    ex = (extra.reshape(n, 3, M) if extra is not None
          else torch.zeros((n, 3, M)))
    r = torch.sigmoid(acc_r + b_i[0] + ex[:, 0] + b_h[0])
    z = torch.sigmoid(acc_z + b_i[1] + ex[:, 1] + b_h[1])
    nn_ = torch.tanh(gi_n + b_i[2] + ex[:, 2] + r * (gh_n + b_h[2]))
    return (1.0 - z) * nn_ + z * s


@pytest.mark.parametrize("with_extra", [True, False])
def test_3xtf32_product_holds_the_kernel_tolerance_at_main_widths(
        with_extra):
    R, F, M = 400, 372, 100
    w_i, w_h, b_i, b_h = _weights(F, M, seed=2)
    rng = np.random.RandomState(3)
    mail, s, extra = (torch.from_numpy(rng.randn(R, w).astype(np.float32))
                      for w in (F, M, 3 * M))
    extra = extra if with_extra else None
    p = ops.pack_gru_params(w_i, w_h, b_i, b_h)
    want = ops.gru_cell_plain(mail, s, w_i, w_h, b_i, b_h, extra)
    torch.testing.assert_close(gru_update_3xtf32(mail, s, p, extra), want,
                               **TOL)
    # a single TF32 pass keeps ~3 digits: outside the tolerance
    one_pass = gru_update_3xtf32(mail, s, p, extra, passes=1)
    assert not torch.allclose(one_pass, want, **TOL)


@pytest.mark.parametrize("mail_width,swap_w_tc,error", [
    (21, True, "w_tc has shape"),        # w_tc packed for a wider F
    (22, False, "w_i has shape"),        # F off by one, same stage count
])
def test_wrapper_refuses_a_pack_of_other_widths(mail_width, swap_w_tc,
                                                error):
    """The CUDA path checks the pack against the inputs' F and M before it
    launches (meta tensors stand in for the card)."""
    F, M, n = 21, 8, 5
    w_i, w_h, b_i, b_h = _weights(F, M)
    p = {k: v.to("meta") for k, v in
         ops.pack_gru_params(w_i, w_h, b_i, b_h).items()}
    if swap_w_tc:
        wider = ops.pack_gru_params(*_weights(F + ops.GRU_DEPTH, M))
        p["w_tc"] = wider["w_tc"].to("meta")
    mail = torch.empty((n, mail_width), device="meta")
    s = torch.empty((n, M), device="meta")
    with pytest.raises(ValueError, match=error):
        ops.gru_cell(mail, s, p)
