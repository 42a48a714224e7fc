"""The port's sharding rules (``repro_torch.distributed.tgn_sharding``):
spec shapes, divisibility fitting, capacity math and mesh-spec parsing,
ported from the reference's ``tests/test_tgn_sharding.py``, on meshes of
repeated CPU devices.

Parity: for every ``VertexState`` field, the batch tuple and the
``BatchOut``, the port's specs name the same logical axes as the
reference's ``state_specs`` / ``batch_specs`` / ``out_specs`` after its
divisibility fitting, on meshes of one repeated JAX CPU device of the
same shapes (``tenant=8``, ``tenant=4,vertex=2``, ``tenant=2,vertex=3``,
whose vertex axis does not divide V, and ``tenant=1``).
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.core import mailbox as jmailbox
from repro.distributed import tgn_sharding as jtsh
from repro_torch.core import mailbox, tgn
from repro_torch.distributed import tgn_sharding as tsh

MESHES = ({"tenant": 8}, {"tenant": 4, "vertex": 2},
          {"tenant": 2, "vertex": 3}, {"tenant": 1}, {"vertex": 2})


def _mesh(**sizes):
    """A mesh of repeats of the host's CPU (spec computation only)."""
    n = int(np.prod(list(sizes.values()))) if sizes else 1
    return tsh.TenantMesh(np.asarray(["cpu"] * n, dtype=object).reshape(
        tuple(sizes.values())), tuple(sizes))


def _jmesh(**sizes):
    n = int(np.prod(list(sizes.values()))) if sizes else 1
    devs = np.asarray([jax.devices()[0]] * n).reshape(tuple(sizes.values()))
    return Mesh(devs, tuple(sizes))


def _like(n_nodes=10_000, f_mem=16):
    return mailbox.init_state(mailbox.TableConfig(n_nodes=n_nodes,
                                                  f_mem=f_mem), "meta")


def _jlike(n_nodes=10_000, f_mem=16):
    return jax.eval_shape(lambda: jmailbox.init_state(
        jmailbox.TableConfig(n_nodes=n_nodes, f_mem=f_mem)))


# ---------------------------------------------------------------------------
# the reference's cases
# ---------------------------------------------------------------------------


def test_stacked_specs_tenant_axis():
    specs = tsh.state_specs(_mesh(tenant=8), _like())
    assert specs.memory == ("tenant", None, None)
    assert specs.last_update == ("tenant", None)
    assert specs.nbr_ids == ("tenant", None, None)


def test_vertex_axis_applied_when_divisible():
    specs = tsh.state_specs(_mesh(tenant=2, vertex=2), _like())
    assert specs.memory == ("tenant", "vertex", None)
    assert specs.mail_ts == ("tenant", "vertex")


def test_vertex_axis_dropped_when_not_divisible():
    specs = tsh.state_specs(_mesh(tenant=2, vertex=2), _like(n_nodes=10_001))
    assert specs.memory == ("tenant", None, None)
    assert tsh.vertex_ranges(_mesh(tenant=2, vertex=2),
                             _like(n_nodes=10_001)) is None
    assert tsh.vertex_ranges(_mesh(tenant=2, vertex=2), _like()) == [
        (0, 5_000), (5_000, 10_000)]


def test_unstacked_specs_for_single_state():
    specs = tsh.state_specs(_mesh(vertex=2), _like(), stacked=False)
    assert specs.memory == ("vertex", None)
    assert specs.nbr_cursor == ("vertex",)


def test_batch_and_out_specs():
    mesh = _mesh(tenant=4)
    assert all(s == ("tenant", None) for s in tsh.batch_specs(mesh))
    out = tsh.out_specs(mesh, _like())
    assert out.emb_src == ("tenant",)
    assert out.state.memory == ("tenant", None, None)
    assert isinstance(out, tgn.BatchOut)


def test_tenant_axis_optional():
    specs = tsh.state_specs(_mesh(vertex=2), _like())
    assert specs.memory == (None, "vertex", None)
    assert tsh.batch_specs(_mesh(vertex=2))[0] == (None, None)


def test_tenant_capacity_rounds_to_axis_multiple():
    mesh = _mesh(tenant=4)
    assert [tsh.tenant_capacity(n, mesh) for n in (0, 1, 4, 5, 8, 9)] == \
        [4, 4, 4, 8, 8, 12]
    assert tsh.tenant_capacity(3, _mesh(vertex=2)) == 3


def test_make_tenant_mesh_specs():
    m = tsh.make_tenant_mesh(1, devices=["cpu"])
    assert m.axis_names == ("tenant",) and m.shape["tenant"] == 1
    m2 = tsh.make_tenant_mesh("tenant=1,vertex=1", devices=["cpu"])
    assert m2.axis_names == ("tenant", "vertex")
    assert tsh.make_tenant_mesh(None, devices=["cpu"] * 3).shape == {
        "tenant": 3}
    m3 = tsh.make_tenant_mesh("vertex=2,tenant=3", devices=["cpu"] * 8)
    assert m3.shape == {"vertex": 2, "tenant": 3}
    assert len(m3.groups()) == 3 and all(len(g) == 2 for g in m3.groups())
    assert m3.distinct_devices == (torch.device("cpu"),)


def test_make_tenant_mesh_errors():
    with pytest.raises(RuntimeError, match="needs 64 devices, found 8"):
        tsh.make_tenant_mesh(64, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="bad mesh clause"):
        tsh.make_tenant_mesh("tenant:2", devices=["cpu"])
    with pytest.raises(ValueError, match="duplicate mesh axis"):
        tsh.make_tenant_mesh("tenant=1,tenant=1", devices=["cpu"])
    with pytest.raises(ValueError, match="bad size"):
        tsh.make_tenant_mesh("tenant=zero", devices=["cpu"])
    with pytest.raises(ValueError, match="unknown mesh axis"):
        tsh.make_tenant_mesh("data=2", devices=["cpu"] * 2)


def test_default_devices_are_the_visible_cards(monkeypatch):
    """Without ``devices`` the mesh takes every visible CUDA device, and
    raises rather than shrink when there are too few (here: none)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="needs 1 devices, found 0"):
        tsh.make_tenant_mesh(None)
    with pytest.raises(RuntimeError, match="needs 4 devices, found 0"):
        tsh.make_tenant_mesh("tenant=2,vertex=2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tsh.make_tenant_mesh(None).devices.tolist() == [
        torch.device("cuda", 0), torch.device("cuda", 1)]


def test_make_shardings_wraps_specs():
    mesh = _mesh(tenant=2)
    sh = tsh.make_shardings(mesh, tsh.state_specs(mesh, _like()))
    assert sh.memory.spec == ("tenant", None, None)
    assert sh.memory.mesh.shape["tenant"] == 2


def test_a_sharding_places_a_leaf_on_its_devices():
    """A split leaf comes back as its pieces, one a device along the
    split axis; an unsplit one whole, on the mesh's first device."""
    mesh = _mesh(vertex=2)
    t = torch.arange(12.0).reshape(6, 2)
    a, b = tsh.NamedSharding(mesh, ("vertex", None)).place(t)
    assert torch.equal(a, t[:3]) and torch.equal(b, t[3:])
    assert torch.equal(tsh.replicated(mesh).place(t), t)


# ---------------------------------------------------------------------------
# parity with the reference's rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: ",".join(
    f"{k}={v}" for k, v in s.items()))
@pytest.mark.parametrize("n_nodes", [10_000, 10_001])
def test_specs_name_the_references_axes(sizes, n_nodes):
    mesh, jmesh = _mesh(**sizes), _jmesh(**sizes)
    like, jlike = _like(n_nodes), _jlike(n_nodes)
    for stacked in (True, False):
        got = tsh.state_specs(mesh, like, stacked=stacked)
        want = jtsh.state_specs(jmesh, jlike, stacked=stacked)
        for f in mailbox.VertexState._fields:
            assert getattr(got, f) == tuple(getattr(want, f)), (f, stacked)
    assert [tuple(s) for s in jtsh.batch_specs(jmesh)] == list(
        tsh.batch_specs(mesh))
    got, want = tsh.out_specs(mesh, like), jtsh.out_specs(jmesh, jlike)
    for f in ("emb_src", "emb_dst", "attn_logits", "nbr_valid", "nbr_dt"):
        assert getattr(got, f) == tuple(getattr(want, f)), f
    for f in mailbox.VertexState._fields:
        assert getattr(got.state, f) == tuple(getattr(want.state, f)), f
    for n in (0, 1, 3, 5, 8, 9):
        assert tsh.tenant_capacity(n, mesh) == jtsh.tenant_capacity(n, jmesh)
