"""Sharding rules for the port's TGN vertex state: the paper's banks, as
mesh axes.

Port of ``repro.distributed.tgn_sharding``. The accelerator keeps its
Graph Storage in banked BRAM partitions so the MUU/EU pipelines can hit
many vertices per cycle (§IV-A); the serving analogue of more banks is
spreading the multi-tenant session's stacked tables over devices:

  * ``tenant`` axis — each device advances its slice of a cohort's
    slots; the step has no cross-tenant reduction, so a slot's results do
    not depend on where its cohort-mates live;
  * ``vertex`` axis — optional second axis splitting each tenant's V
    rows, the analogue of the paper's vertex-id bank interleaving.

``TenantMesh`` is the port's mesh: named axes over a numpy array of
``torch.device``s, driven by one process (single-controller, as the
reference's ``jax.sharding.Mesh`` is). A spec is a tuple with one entry a
dimension: an axis name, or None (that dimension is not split). The rule
table maps each ``VertexState`` field, the padded batch tuple and the
``BatchOut`` to specs over the reference's logical layout, ``(tenant, V,
...)`` for stacked leaves; axes that do not divide their dimension are
dropped rather than rejected, so one table serves any mesh shape.

The port stacks a cohort as ``capacity·V + 1`` flat rows with one scratch
row (``core/mailbox.py::stack_states``), so ``serving/cluster.py`` reads
the same axes in that layout: a tenant shard is a contiguous range of
``capacity / n_tenant`` slots with tables of its own (``(capacity /
n_tenant)·V + 1`` rows: its own scratch row, row ids from its own base),
and a vertex shard is a contiguous range of ``V / n_vertex`` rows of each
of its tenants (``vertex_ranges``).
"""
from __future__ import annotations

import math
import re
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import mailbox, tgn

TENANT_AXIS = "tenant"
VERTEX_AXIS = "vertex"
_AXES = (TENANT_AXIS, VERTEX_AXIS)

# (regex on VertexState field name, spec for the UNSTACKED leaf, V leading).
# First match wins; a stacked (tenant, V, ...) leaf left-pads TENANT_AXIS.
STATE_RULES = [
    # 2-D tables: (V, f_mem) memory, (V, f_mail_raw) mail,
    # (V, m_r) ring buffers — V over the vertex axis, feature dims local
    (r"^(memory|mail|nbr_ids|nbr_ts|nbr_eid)$", (VERTEX_AXIS, None)),
    # 1-D per-vertex scalars
    (r"^(last_update|mail_ts|mail_valid|nbr_cursor)$", (VERTEX_AXIS,)),
    (r".*", ()),
]

_FIELDS = mailbox.VertexState._fields


class TenantMesh:
    """Named axes over an array of devices, one process driving all of
    them. ``devices`` may repeat a device (several shards on one card, or
    on the host's CPU in tests)."""

    def __init__(self, devices, axis_names):
        flat = list(np.asarray(devices, dtype=object).reshape(-1))
        arr = np.empty(len(flat), dtype=object)
        arr[:] = [torch.device(d) for d in flat]
        self.axis_names = tuple(axis_names)
        self.devices = arr.reshape(np.shape(devices))
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d devices for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def distinct_devices(self) -> tuple:
        """Each device once, in mesh order."""
        return tuple(dict.fromkeys(self.devices.reshape(-1)))

    def groups(self) -> list:
        """Per tenant-axis index, the devices of its vertex group (one
        device when the mesh has no vertex axis)."""
        arr, names = self.devices, list(self.axis_names)
        for name in _AXES:
            if name not in names:
                arr, names = arr[..., None], names + [name]
        arr = np.moveaxis(arr, [names.index(a) for a in _AXES], [0, 1])
        return [list(row) for row in arr]


class NamedSharding(NamedTuple):
    """A leaf's placement: ``spec`` over ``mesh``."""
    mesh: TenantMesh
    spec: tuple

    def place(self, t: torch.Tensor):
        """``t`` on its devices: a tensor on the mesh's first device when
        no dimension is split, else a tuple of the pieces of the first
        split dimension, piece i on the i-th device along its axis."""
        mesh = self.mesh
        for dim, ax in enumerate(self.spec):
            n = _axis_size(mesh, ax) if ax is not None else 1
            if n > 1:
                lead = np.moveaxis(mesh.devices,
                                   mesh.axis_names.index(ax), 0)
                devs = lead.reshape(n, -1)[:, 0]
                return tuple(p.to(d) for p, d in zip(
                    torch.chunk(t, n, dim=dim), devs))
        return t.to(mesh.devices.reshape(-1)[0])


def _axis_size(mesh: TenantMesh, name: str) -> int:
    return int(mesh.shape.get(name, 1))


def _fit_axes(spec: tuple, shape, mesh: TenantMesh) -> tuple:
    """Drop spec axes absent from the mesh or not dividing their dim."""
    entries = list(tuple(spec) + (None,) * (len(shape) - len(spec)))
    for i, (dim, ax) in enumerate(zip(shape, entries)):
        if ax is None:
            continue
        n = _axis_size(mesh, ax)
        if n <= 1 or dim % n != 0:
            entries[i] = None
    return tuple(entries)


def _field_spec(field: str) -> tuple:
    for pat, spec in STATE_RULES:
        if re.match(pat, field):
            return spec
    raise AssertionError("unreachable")


def _tenant_axis(mesh: TenantMesh):
    """The tenant shard axis, or None on a mesh without one."""
    return TENANT_AXIS if TENANT_AXIS in mesh.axis_names else None


def state_specs(mesh: TenantMesh, state_like: mailbox.VertexState, *,
                stacked: bool = True) -> mailbox.VertexState:
    """Specs for a VertexState of UNSTACKED leaves (anything with a
    ``shape``, V leading). ``stacked=True``: the specs of the leaves with
    a leading tenant dim ``(T, V, ...)`` sharded over ``tenant`` (T is a
    capacity, a multiple of the axis); the V dim also shards over
    ``vertex`` where that axis exists and divides it."""
    out = []
    for field, leaf in zip(_FIELDS, state_like):
        spec = _fit_axes(_field_spec(field), tuple(leaf.shape), mesh)
        if stacked:
            spec = (_tenant_axis(mesh), *spec)
        out.append(spec)
    return mailbox.VertexState(*out)


def batch_specs(mesh: TenantMesh) -> tuple:
    """Specs for the stacked padded batch tuple: five (T, B) arrays (src,
    dst, eid, ts, valid), row-sharded over the tenant axis."""
    return tuple((_tenant_axis(mesh), None) for _ in range(5))


def out_specs(mesh: TenantMesh, state_like: mailbox.VertexState) -> tgn.BatchOut:
    """Specs for a cohort launch's BatchOut: the committed stacked state
    keeps its layout, every per-tenant output is tenant-sharded on its
    leading axis."""
    t = (_tenant_axis(mesh),)
    return tgn.BatchOut(state=state_specs(mesh, state_like, stacked=True),
                        emb_src=t, emb_dst=t, attn_logits=t,
                        nbr_valid=t, nbr_dt=t)


def replicated(mesh: TenantMesh) -> NamedSharding:
    """The sharding of cohort-shared operands (params, edge/node feature
    stores): nothing split. The fabric keeps a copy of each on every
    distinct device (``ShardedSessionManager``); ``place`` puts one on
    the mesh's first device."""
    return NamedSharding(mesh, ())


def make_shardings(mesh: TenantMesh, spec_tree):
    """A spec tree as a tree of ``NamedSharding``s."""
    return tree.map(lambda s: NamedSharding(mesh, s), spec_tree,
                    is_leaf=lambda x: isinstance(x, tuple)
                    and not hasattr(x, "_fields"))


def tenant_capacity(n_tenants: int, mesh: TenantMesh) -> int:
    """Stacked-table slots for ``n_tenants``: the smallest multiple of the
    tenant-axis size that fits them (pad slots are idle-masked)."""
    n = max(1, _axis_size(mesh, TENANT_AXIS))
    return max(n, n * math.ceil(n_tenants / n))


def vertex_ranges(mesh: TenantMesh, state_like: mailbox.VertexState):
    """``[(lo, hi), ...]``: each vertex-group device's contiguous range of
    a tenant's V rows, or None when the mesh does not split V (no vertex
    axis, or one that does not divide V)."""
    if state_specs(mesh, state_like, stacked=False).memory[0] is None:
        return None
    V = state_like.memory.shape[0]
    n = _axis_size(mesh, VERTEX_AXIS)
    return [(j * V // n, (j + 1) * V // n) for j in range(n)]


# ---------------------------------------------------------------------------
# mesh construction
# ---------------------------------------------------------------------------


def mesh_sizes(spec: str | int | None, n_devices: int) -> dict:
    """``{axis: size}`` of a CLI-style mesh spec: ``None``/``""`` (every
    one of ``n_devices`` on the tenant axis), an int or numeric string
    (``"8"`` — tenant axis of that size), or an explicit
    ``"tenant=4,vertex=2"`` assignment; axis order follows the spec."""
    if spec is None or spec == "":
        return {TENANT_AXIS: n_devices}
    if isinstance(spec, int) or str(spec).isdigit():
        return {TENANT_AXIS: int(spec)}
    sizes = {}
    for clause in str(spec).split(","):
        if "=" not in clause:
            raise ValueError(
                f"bad mesh clause {clause!r} in {spec!r}; expected "
                "'<axis>=<size>[,...]' e.g. 'tenant=4,vertex=2'")
        name, _, size = clause.partition("=")
        name = name.strip()
        if name in sizes:
            raise ValueError(f"duplicate mesh axis {name!r} in {spec!r}")
        if name not in _AXES:
            raise ValueError(f"unknown mesh axis {name!r} in {spec!r}; "
                             f"the tenant fabric lays out {_AXES}")
        if not size.strip().isdigit() or int(size) < 1:
            raise ValueError(f"bad size for mesh axis {name!r} in "
                             f"{spec!r}")
        sizes[name] = int(size)
    return sizes


def make_tenant_mesh(spec: str | int | None = None, *,
                     devices=None) -> TenantMesh:
    """Build the tenant fabric's device mesh from a CLI-style spec
    (``mesh_sizes``). ``devices``: every visible CUDA device unless
    given; a given list may repeat a device (``["cuda:0"] * 4``). A mesh
    that needs more devices than there are raises: it never shrinks to
    fit."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    sizes = mesh_sizes(spec, len(devices))
    n = math.prod(sizes.values())
    if n < 1 or n > len(devices):
        raise RuntimeError(
            f"mesh {sizes} needs {max(n, 1)} devices, found "
            f"{len(devices)} — pass devices= (e.g. ['cpu'] * {max(n, 1)} "
            "on a host without a card, or repeats of one card), or shrink "
            "the mesh")
    return TenantMesh(np.asarray(devices[:n], dtype=object).reshape(
        tuple(sizes.values())), tuple(sizes))
