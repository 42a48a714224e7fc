"""The port's performance models (``repro_torch.core.perf_model``) against
the reference's (``repro.core.perf_model``).

The paper's §V FPGA model (Eqs. 18-22) must give the reference's numbers
at rtol 1e-12 over a sweep of design points on both boards. The roofline
takes a chip spec: held to the reference's with the reference's own
constants passed in as a ``ChipSpec``, it must compute the same terms;
the port's H100 spec is checked against the bounds ``chip_smoke.py``
prints from it.
"""
import itertools

import pytest

from repro.core import perf_model as ref
from repro_torch.core import perf_model as pm

RTOL = 1e-12


def _close(a, b):
    assert a == pytest.approx(b, rel=RTOL, abs=0.0)


def _pair(board, **kw):
    """The same design point in both packages."""
    return (getattr(ref, board).replace(**kw),
            getattr(pm, board).replace(**kw))


@pytest.mark.parametrize("board", ["U200", "ZCU104"])
def test_design_points_are_the_papers(board):
    assert getattr(pm, board).asdict() == getattr(ref, board).asdict()


@pytest.mark.parametrize("board", ["U200", "ZCU104"])
def test_fpga_model_equals_the_reference_over_a_sweep(board):
    for n_b, s_g, m_r, f_feat in itertools.product(
            (1, 4, 8, 32), (2, 4, 8, 16), (2, 6, 10, 20), (0, 100, 172)):
        jc, tc = _pair(board, n_b=n_b, s_g=s_g, m_r=m_r, f_feat=f_feat)
        _close(pm.t_comp_max(tc), ref.t_comp_max(jc))
        _close(pm.t_ls(tc), ref.t_ls(jc))
        for batch in (1, 200, 1000):
            want, got = ref.predict(jc, batch), pm.predict(tc, batch)
            assert got.keys() == want.keys()
            assert got["compute_bound"] == want["compute_bound"]
            for k in ("t_p_s", "throughput_eps", "latency_s"):
                _close(got[k], want[k])


@pytest.mark.parametrize("l_elems,z_d", [(0, 4), (1, 4), (100, 4),
                                         (372, 4), (4096, 2), (10**6, 4)])
def test_alpha_burst_equals_the_reference(l_elems, z_d):
    _close(pm.alpha_burst(l_elems, z_d), ref.alpha_burst(l_elems, z_d))


def test_roofline_with_the_reference_constants_equals_the_reference():
    spec = pm.ChipSpec(name="reference constants", fp32_flops=1.0,
                       tf32_flops=1.0, bf16_flops=ref.PEAK_FLOPS,
                       hbm_bytes_per_s=ref.HBM_BW,
                       link_bytes_per_s=ref.ICI_BW, hbm_bytes=1.0)
    for flops, nbytes, coll, links in itertools.product(
            (0.0, 3.2e9, 7.7e14), (0.0, 1.5e8, 2.1e12), (0.0, 4e6, 9e10),
            (1, 2, 4)):
        want = ref.roofline(flops, nbytes, coll, 8, ici_links=links)
        got = pm.roofline(flops, nbytes, coll, links, chip=spec,
                          precision="bf16")
        for k in ("compute_s", "memory_s", "collective_s", "step_time_s",
                  "roofline_fraction"):
            _close(getattr(got, k), getattr(want, k))
        assert got.bound == want.bound


@pytest.mark.parametrize("training", [True, False])
def test_model_flops_equals_the_reference(training):
    for n, d in ((1, 1), (7_000_000, 4096), (10**11, 3 * 10**6)):
        _close(pm.model_flops(n, d, training=training),
               ref.model_flops(n, d, training=training))


def test_h100_bounds_are_chip_smokes():
    """The kernel table's bounds at 400 rows (PERF.md): lut_encode is bound
    by bytes, gru_cell by fp32 operations; the figures are the card's."""
    h = pm.H100_SXM
    assert (h.fp32_flops, h.hbm_bytes_per_s) == (67e12, 3.35e12)
    assert h.peak_flops("tf32") < h.peak_flops("bf16")
    rl = pm.roofline(2 * 400 * (372 + 100) * 300 + 12 * 400 * 100, 0.0)
    assert rl.bound == "compute" and rl.compute_s * 1e6 == pytest.approx(
        1.698, abs=5e-4)
    with pytest.raises(ValueError, match="unknown precision"):
        h.peak_flops("fp8")
