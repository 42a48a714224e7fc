"""The port's serving stack on the card.

Every test here is marked ``cuda`` and skips where there is no CUDA device.
On a GPU machine run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_serving_cuda.py

The module imports neither JAX nor the reference package.

- A snapshot taken right before rounds that commit the cohort's tables in
  place holds the state of the moment it was taken, bit for bit: the
  capture copies the rows on the serving stream before those rounds, and
  the writer waits for the copies (``cluster._capture_tenant``), which the
  test queues behind a long device wait.
- The finite-state sentinel gives on the card what it gives on the CPU
  for a poisoned cohort (a NaN tenant, a NaN scratch row).
- A degraded cohort launches the staged kernels where it launched
  ``fused_step``.
"""
import pytest
import torch

from repro_torch.core import mailbox, pipeline as pl, tgn
from repro_torch.data import stream, temporal_graph as tgd
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.kernels import ops
from repro_torch.serving import cluster
from repro_torch.serving.faults import FakeClock, Fault, FaultInjector
from repro_torch.serving.guard import FleetGuard
from repro_torch.serving.session import SessionManager


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def graph():
    return tgd.wikipedia_like(n_edges=4000)


def _mgr(g, device, tier="fused", f=100, **kw):
    cfg = pl.variant_config("sat+lut+np4", n_nodes=g.cfg.n_nodes,
                            n_edges=g.n_edges, f_edge=172, f_mem=f,
                            f_time=f, f_emb=f, m_r=10)
    params = tgn.init_params(torch.Generator().manual_seed(0), cfg, device)
    return SessionManager(params, g.edge_feats, model=cfg, use_kernels=tier,
                          device=device, **kw)


def _rounds(g, i, n, B=200):
    lo = i * n * B
    return list(stream.fixed_count(g, B, window=slice(lo, lo + n * B),
                                   seed=i))


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _equal(a, b) -> bool:
    return all(torch.equal(_bits(x.cpu()), _bits(y.cpu()))
               for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("background", [True, False])
def test_snapshot_before_an_inplace_round_is_not_torn(cuda_device, graph,
                                                      tmp_path, background):
    g = graph
    mgr = _mgr(g, cuda_device)
    t0, t1 = mgr.add_tenant(), mgr.add_tenant()
    r0, r1 = _rounds(g, 0, 8), _rounds(g, 1, 8)
    for k in range(3):
        mgr.step({t0: r0[k], t1: r1[k]})
    before = mgr.state_of(t0)
    root = str(tmp_path / "snaps")
    writer = cluster.TenantSnapshotWriter(root)
    # hold the stream ~50 ms so the capture's copies land well after it
    # returns: a writer that reads before the capture's event is torn
    torch.cuda._sleep(100_000_000)
    if background:
        assert writer.submit(mgr, t0, step=3)
    else:
        cluster.snapshot_tenant(mgr, t0, root, step=3)
    for k in range(3, 8):                  # in-place commits, no wait
        mgr.step({t0: r0[k], t1: r1[k]})
    writer.close()
    mgr.sync()
    snap, _ = ckpt.restore(f"{root}/{t0}", before._asdict(), device="cpu")
    assert _equal(mailbox.VertexState(**snap), before)
    assert not _equal(mgr.state_of(t0), before)      # the rounds moved it


@pytest.mark.cuda
def test_sentinel_on_the_card_matches_the_cpu(cuda_device, graph):
    got = {}
    for device in (cuda_device, torch.device("cpu")):
        mgr = _mgr(graph, device, f=16, reserve=True)
        tids = [mgr.add_tenant() for _ in range(3)]
        mgr.step({t: _rounds(graph, i, 1, B=50)[0]
                  for i, t in enumerate(tids)})
        cohort = mgr.cohort_of(tids[0])
        cohort.state.memory[-1] = float("nan")        # the scratch row
        st = mgr.state_of(tids[1])
        mgr.set_state(tids[1], st._replace(
            memory=torch.full_like(st.memory, float("nan"))))
        guard = FleetGuard(mgr, clock=FakeClock(), backoff_s=100.0,
                           backoff_cap_s=100.0)
        flags = cohort.finite_slots().cpu().tolist()
        guard._health_check()
        got[device.type] = (flags, sorted(mgr.quarantined))
    assert got["cuda"] == got["cpu"] == ([True, False, True, True], ["t1"])


@pytest.mark.cuda
def test_degraded_cohort_launches_the_staged_kernels(cuda_device, graph):
    g = graph
    mgr = _mgr(g, cuda_device)
    t0, t1 = mgr.add_tenant(), mgr.add_tenant()
    mgr.set_faults(FaultInjector([Fault(kind="kernel_fail", tenant=t0,
                                        at=2)]))
    guard = FleetGuard(mgr, clock=FakeClock())
    r0, r1 = _rounds(g, 0, 4), _rounds(g, 1, 4)
    per_round = []
    for k in range(4):
        ops.reset_launch_counts()
        guard.step({t0: r0[k], t1: r1[k]})
        per_round.append(ops.launch_counts())
    fused = {"lut_encode": 0, "gru_cell": 0, "sat_aggregate": 0,
             "fused_step": 1}
    staged = {"lut_encode": 1, "gru_cell": 1, "sat_aggregate": 1,
              "fused_step": 0}
    assert per_round == [fused, fused, staged, staged]
    assert guard.degradations == 1 and mgr.cohort_of(t0).tier == "staged"
