"""Vertex state tables: Mailbox, Memory Table, Neighbor (ring-buffer) Table.

Port of ``repro.core.mailbox``. The tables are dense tensors on one device;
updates are functional (a step returns new tensors), as in the reference,
so a trajectory can be held against the reference table by table; a
serving cohort's stacked tables (``stack_states``) are written in place
by the ``*_`` functions.

Out-of-bounds indices: the reference sends padding rows to index ``V`` and
relies on JAX dropping the out-of-bounds scatter and clamping the gather.
Torch raises on the CPU and device-asserts on CUDA, so here every such row
is redirected to a scratch row ``V`` of an extended table that is sliced off
afterwards, and gathers clamp explicitly.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.utils import FrozenConfig


class VertexState(NamedTuple):
    """The complete per-vertex dynamic state."""
    memory: torch.Tensor        # (V, f_mem) float32
    last_update: torch.Tensor   # (V,) float32 — timestamp of last memory update
    mail: torch.Tensor          # (V, f_mail_raw) float32 — s_src||s_dst||f_e
    mail_ts: torch.Tensor       # (V,) float32 — timestamp of cached message
    mail_valid: torch.Tensor    # (V,) bool — has this vertex any cached message
    nbr_ids: torch.Tensor       # (V, m_r) int32 — ring buffer of neighbor ids
    nbr_ts: torch.Tensor        # (V, m_r) float32 — interaction timestamps
    nbr_eid: torch.Tensor       # (V, m_r) int32 — edge-feature row pointers
    nbr_cursor: torch.Tensor    # (V,) int32 — rotating write cursor


@dataclasses.dataclass(frozen=True)
class TableConfig(FrozenConfig):
    n_nodes: int = 10_000
    f_mem: int = 100
    f_edge: int = 172
    m_r: int = 10            # neighbor buffer width (paper samples 10)


def init_state(cfg: TableConfig, device) -> VertexState:
    V, mr = cfg.n_nodes, cfg.m_r
    f_mail_raw = 2 * cfg.f_mem + cfg.f_edge
    f32, i32 = torch.float32, torch.int32
    return VertexState(
        memory=torch.zeros((V, cfg.f_mem), dtype=f32, device=device),
        last_update=torch.zeros((V,), dtype=f32, device=device),
        mail=torch.zeros((V, f_mail_raw), dtype=f32, device=device),
        mail_ts=torch.zeros((V,), dtype=f32, device=device),
        mail_valid=torch.zeros((V,), dtype=torch.bool, device=device),
        nbr_ids=torch.zeros((V, mr), dtype=i32, device=device),
        nbr_ts=torch.full((V, mr), -1.0, dtype=f32, device=device),
        nbr_eid=torch.zeros((V, mr), dtype=i32, device=device),
        nbr_cursor=torch.zeros((V,), dtype=i32, device=device),
    )


# ---------------------------------------------------------------------------
# Neighbor ring buffer (FIFO hardware sampler analogue)
# ---------------------------------------------------------------------------


def insert_neighbors(state: VertexState, src: torch.Tensor,
                     dst: torch.Tensor, eid: torch.Tensor, ts: torch.Tensor,
                     valid: torch.Tensor | None = None) -> VertexState:
    """Insert edges (src->dst and dst->src) into the ring buffers of
    ``state`` (V rows): ``insert_neighbors_`` on a copy of its tables,
    returned as a new state."""
    V = state.nbr_ids.shape[0]
    tables = insert_neighbors_(stack_states([state], state), src, dst, eid,
                               ts, valid)
    return tenant_view(tables, 0, V)


def insert_neighbors_(tables: VertexState, src: torch.Tensor,
                      dst: torch.Tensor, eid: torch.Tensor, ts: torch.Tensor,
                      valid: torch.Tensor | None = None) -> VertexState:
    """Insert edges (src->dst and dst->src) into the ring buffers IN PLACE.

    ``tables`` are ``stack_states`` tables: T tenants' rows, then one
    scratch row. ``src, dst, eid, ts``: (B,), or (T, B) for a cohort.
    Each edge contributes dst to src's buffer and src to dst's buffer at
    the vertex's rotating cursor; a per-vertex chronological occurrence
    count gives every insert of the batch its own slot, identical to the
    FIFO pushing edges one by one.

    A vertex inserted more than ``m_r`` times in one batch wraps onto slots
    it already wrote in this batch. The reference's scatter then keeps the
    write that comes LAST IN ARRAY ORDER (the ``concat([src, dst])`` layout;
    XLA's CPU scatter runs its updates in order). CUDA scatters promise no
    order, so that rule is made explicit here: only the last writer of each
    (vertex, slot) pair in array order writes; the rest write the scratch
    row.

    ``valid``: optional (B,) bool — padding rows write nothing.

    Tenant t's vertex v is row t·V + v. Occurrences and last writers are
    counted within each tenant's block (its src rows, then its dst rows),
    never across tenants; the stored neighbour ids stay the tenant's own.
    """
    T = src.shape[0] if src.dim() == 2 else 1
    src, dst, eid, ts = (x.reshape(T, -1) for x in (src, dst, eid, ts))
    rows = tables.nbr_ids.shape[0] - 1              # real rows, T·V
    V, mr = rows // T, tables.nbr_ids.shape[1]
    B = src.shape[1]
    ids = torch.cat([src, dst], dim=1).long()        # vertex appended to
    nbrs = torch.cat([dst, src], dim=1).to(torch.int32)  # neighbor stored
    eids = torch.cat([eid, eid], dim=1).to(torch.int32)
    tss = torch.cat([ts, ts], dim=1).to(torch.float32)
    if valid is not None:
        vv = torch.cat([valid, valid], dim=-1).reshape(T, -1)
        ids = torch.where(vv, ids, torch.full_like(ids, V))  # -> scratch
    occ = _occurrence_index(ids, updater_order(B, ids.device))
    gid = ids
    if T > 1:
        base = torch.arange(T, device=ids.device)[:, None] * V
        gid = torch.where(ids < V, ids + base, torch.full_like(ids, rows))
    cur = tables.nbr_cursor[gid.clamp(max=rows - 1)].long()
    slot = (cur + occ) % mr
    # last writer per (vertex, slot) in array order; the rest -> scratch row
    n = ids.shape[1]
    same = ((ids[..., None, :] == ids[..., :, None])
            & (slot[..., None, :] == slot[..., :, None]))
    later = torch.arange(n, device=ids.device)
    later = later[None, :] > later[:, None]
    last = ~(same & later).any(dim=-1)
    wid = torch.where(last, gid, torch.full_like(gid, rows))
    tables.nbr_ids[wid, slot] = nbrs
    tables.nbr_ts[wid, slot] = tss
    tables.nbr_eid[wid, slot] = eids
    gid = gid.reshape(-1)
    tables.nbr_cursor.index_add_(0, gid, torch.ones_like(gid,
                                                         dtype=torch.int32))
    tables.nbr_cursor.remainder_(2 ** 30)
    return tables


def updater_order(B: int, device) -> torch.Tensor:
    """Chronological positions for the concat([src, dst]) layout."""
    a = torch.arange(B, device=device)
    return torch.cat([2 * a, 2 * a + 1])


def _occurrence_index(ids: torch.Tensor,
                      order: torch.Tensor | None = None) -> torch.Tensor:
    """occ[i] = number of j with ids[j]==ids[i] and order[j] < order[i].
    O(B^2) compare — B is a processing micro-batch. ``ids`` (T, n) counts
    within each tenant's block."""
    if order is None:
        order = torch.arange(ids.shape[-1], device=ids.device)
    same = ids[..., None, :] == ids[..., :, None]
    before = order[None, :] < order[:, None]
    return (same & before).sum(dim=-1)


# ---------------------------------------------------------------------------
# A cohort's stacked tables
# ---------------------------------------------------------------------------


def stack_states(states, scratch: VertexState) -> VertexState:
    """The tables of ``states`` (T tenants, V rows each) as one state of
    flat tables of T·V + 1 rows: tenant t's rows at [t·V, (t+1)·V), then
    one scratch row that every redirected write of the cohort lands in
    (losers, padding rows) and no vertex reads. ``scratch`` supplies that
    row's values (any state; its row 0 is taken)."""
    return VertexState(*(torch.cat([*(getattr(s, f) for s in states),
                                    getattr(scratch, f)[:1]]).contiguous()
                         for f in VertexState._fields))


def tenant_view(tables: VertexState, i: int, V: int) -> VertexState:
    """Tenant ``i``'s (V, ...) rows of ``stack_states`` tables (views)."""
    return VertexState(*(t[i * V:(i + 1) * V] for t in tables))


def gather_neighbors(state: VertexState, vids: torch.Tensor):
    """Read the ring buffer for a batch of vertices.

    Returns (nbr_ids, nbr_ts, nbr_eid, valid_mask), each (B, m_r), rolled so
    column 0 is the most recent slot (cursor-1), then cursor-2, ...
    """
    vids = vids.long()
    ids = state.nbr_ids[vids]
    ts = state.nbr_ts[vids]
    eid = state.nbr_eid[vids]
    cur = state.nbr_cursor[vids].long()
    mr = ids.shape[1]
    col = torch.arange(mr, device=vids.device)
    src_slot = (cur[:, None] - 1 - col) % mr
    ids = torch.gather(ids, 1, src_slot)
    ts = torch.gather(ts, 1, src_slot)
    eid = torch.gather(eid, 1, src_slot)
    return ids, ts, eid, ts >= 0.0
