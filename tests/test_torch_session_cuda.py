"""The port's multi-tenant session on the card.

Every test here is marked ``cuda`` and skips where there is no CUDA device.
On a GPU machine run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_session_cuda.py

The module imports neither JAX nor the reference package. A mixed fleet
(np4 on the fused and staged tiers, np4 + reservoir fused, sat+lut staged,
the teacher on its own weights) is served through the coalesced round on
the card: each tenant must equal the same tenant served alone on the card
bit for bit, each kernel must launch once a round per cohort of its lane,
and the fleet must agree with the same fleet on the CPU (whose kernel
entry points run their plain versions) to rtol = atol = 1e-4 over the
rounds: fp32 sums in other orders, carried forward by the GRU. The
reservoir lane is held to the CPU only through its solo run on the card:
its priorities, log(u) * exp(dt / tau), differ by an ulp between
libraries (tests/test_torch_ladder.py), which can swap a winner.
"""
import pytest
import torch

from repro_torch.core import attention, mailbox, tgn
from repro_torch.core import pipeline as pl
from repro_torch.data import stream, temporal_graph as tgd
from repro_torch.kernels import ops
from repro_torch.serving.session import SessionManager

TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)
LANES = (("sat+lut+np4", "fused", None), ("sat+lut+np4", "fused", None),
         ("sat+lut+np4", "staged", None),
         ("sat+lut+np4+reservoir", "fused", None),
         ("sat+lut", "staged", None), ("teacher", "staged", "teacher"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _fleet(g, dims, device, lanes):
    cfg = pl.variant_config("sat+lut+np4", **dims)
    tcfg = pl.variant_config("teacher", **dims)
    params = tgn.init_params(torch.Generator().manual_seed(0), cfg, device)
    mgr = SessionManager(params, g.edge_feats, model=cfg, device=device)
    mgr.register_params("teacher", tgn.init_params(
        torch.Generator().manual_seed(1), tcfg, device))
    tids = [mgr.add_tenant(v, use_kernels=t, params=p) for v, t, p in lanes]
    return mgr, tids


def _feeds(g, n, rounds=4, B=30):
    return [list(stream.fixed_count(g, B, window=slice(i * 70,
                                                       i * 70 + rounds * B),
                                    seed=i)) for i in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("f", [16, 100])
def test_fleet_on_card_equals_solo_and_the_cpu(cuda_device, f):
    g = tgd.wikipedia_like(n_edges=600)
    dims = dict(n_nodes=g.cfg.n_nodes, n_edges=g.n_edges, f_edge=172,
                f_mem=f, f_time=f, f_emb=f, m_r=10)
    feeds = _feeds(g, len(LANES))
    mgr, tids = _fleet(g, dims, cuda_device, LANES)
    cpu, ctids = _fleet(g, dims, "cpu", LANES)
    solos = [_fleet(g, dims, cuda_device, [lane]) for lane in LANES]
    ops.reset_launch_counts()
    outs = []
    for r in range(4):
        batches = {i: feeds[i][r] for i in range(len(LANES))
                   if not (r == 2 and i == 2)}   # the staged lane idles
        outs.append((batches, mgr.step({tids[i]: b
                                        for i, b in batches.items()})))
    counts = ops.launch_counts()
    # cohorts: np4 fused, np4 staged, reservoir fused, sat+lut staged,
    # teacher (no kernel); an idle cohort still runs (one masked row)
    assert counts == {"fused_step": 8, "lut_encode": 8, "gru_cell": 8,
                      "sat_aggregate": 8}, counts
    for r, (batches, out) in enumerate(outs):
        cout = cpu.step({ctids[i]: b for i, b in batches.items()})
        for i, b in batches.items():
            sm, (st,) = solos[i]
            one = sm.step({st: b})[st]
            for name in ("emb_src", "emb_dst", "attn_logits", "nbr_valid",
                         "nbr_dt"):
                a = getattr(out[tids[i]], name)
                assert torch.equal(a, getattr(one, name)), (r, i, name)
                if "reservoir" in LANES[i][0]:
                    continue
                c = getattr(cout[ctids[i]], name)
                if a.dtype == torch.bool:
                    assert torch.equal(a.cpu(), c), (r, i, name)
                else:
                    torch.testing.assert_close(a.cpu(), c, **TRAJ_TOL)
    for i, tid in enumerate(tids):
        sm, (st,) = solos[i]
        got, alone, want = (mgr.state_of(tid), sm.state_of(st),
                            cpu.state_of(ctids[i]))
        for name in mailbox.VertexState._fields:
            a = getattr(got, name)
            assert torch.equal(a, getattr(alone, name)), (i, name)
            if "reservoir" in LANES[i][0]:
                continue
            if a.dtype.is_floating_point:
                torch.testing.assert_close(a.cpu(), getattr(want, name),
                                           **TRAJ_TOL)
            else:
                assert torch.equal(a.cpu(), getattr(want, name)), (i, name)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [60, 400])
def test_sat_logits_rows_do_not_depend_on_the_rows_beside_them(cuda_device,
                                                               rows):
    """A cohort of T tenants gives sat_logits T·rows rows; each tenant's
    logits must be bitwise those of its rows alone (the property a fleet
    tenant's equality with its solo run rests on)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = {"a": torch.randn(10, generator=gen, device=cuda_device),
              "w_t": torch.randn((10, 10), generator=gen,
                                 device=cuda_device) * 0.01}
    for T in (2, 3, 8, 16):
        dt = torch.rand((T * rows, 10), generator=gen,
                        device=cuda_device) * 1e5
        full = attention.sat_logits(params, dt)
        for t in range(T):
            part = slice(t * rows, (t + 1) * rows)
            assert torch.equal(full[part],
                               attention.sat_logits(params, dt[part])), (T, t)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,pset", [("sat+lut+np4", None),
                                          ("teacher", "teacher")])
@pytest.mark.parametrize("T", [2, 8])
def test_ref_cohort_equals_its_solo_runs_bit_for_bit(cuda_device, variant,
                                                     pset, T):
    """A ref-tier cohort of T tenants at paper width and B = 200 (T·400
    rows a product, where cuBLAS picks another algorithm than at 400):
    each tenant's outputs and state equal its solo run bit for bit,
    because the ref stages run each tenant's rows on their own."""
    g = tgd.wikipedia_like(n_edges=T * 3 * 200)
    dims = dict(n_nodes=g.cfg.n_nodes, n_edges=g.n_edges, f_edge=172,
                f_mem=100, f_time=100, f_emb=100, m_r=10)
    lane = (variant, "ref", pset)
    feeds = _feeds(g, T, rounds=3, B=200)
    mgr, tids = _fleet(g, dims, cuda_device, [lane] * T)
    outs = [mgr.step({t: feeds[i][r] for i, t in enumerate(tids)})
            for r in range(3)]
    for i, tid in enumerate(tids):
        sm, (st,) = _fleet(g, dims, cuda_device, [lane])
        for r in range(3):
            one = sm.step({st: feeds[i][r]})[st]
            for name in ("emb_src", "emb_dst", "attn_logits", "nbr_dt"):
                assert torch.equal(getattr(outs[r][tid], name),
                                   getattr(one, name)), (i, r, name)
        for name, a, b in zip(mailbox.VertexState._fields,
                              mgr.state_of(tid), sm.state_of(st)):
            assert torch.equal(a, b), (i, name)
