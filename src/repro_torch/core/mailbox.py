"""Vertex state tables: Mailbox, Memory Table, Neighbor (ring-buffer) Table.

Port of ``repro.core.mailbox``. The tables are dense tensors on one device;
updates are functional (a step returns new tensors), as in the reference,
so a trajectory can be held against the reference table by table.

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
    """Insert edges (src->dst and dst->src) into the ring buffers.

    ``src, dst, eid, ts``: (B,). Each edge contributes dst to src's buffer
    and src to dst's buffer at the vertex's rotating cursor; a per-vertex
    chronological occurrence count gives every insert of the batch its own
    slot, identical to the FIFO pushing edges one by one.

    A vertex inserted more than ``m_r`` times in one batch wraps onto slots
    it already wrote in this batch. The reference's scatter then keeps the
    write that comes LAST IN ARRAY ORDER (the ``concat([src, dst])`` layout;
    XLA's CPU scatter runs its updates in order). CUDA scatters promise no
    order, so that rule is made explicit here: only the last writer of each
    (vertex, slot) pair in array order writes.

    ``valid``: optional (B,) bool — padding rows write nothing.
    """
    V, mr = state.nbr_ids.shape
    B = src.shape[0]
    ids = torch.cat([src, dst]).long()               # vertex appended to
    nbrs = torch.cat([dst, src]).to(torch.int32)     # the neighbor id stored
    eids = torch.cat([eid, eid]).to(torch.int32)
    tss = torch.cat([ts, ts]).to(torch.float32)
    if valid is not None:
        vv = torch.cat([valid, valid])
        ids = torch.where(vv, ids, torch.full_like(ids, V))   # -> scratch
    occ = _occurrence_index(ids, updater_order(B, ids.device))
    cur = state.nbr_cursor[ids.clamp(max=V - 1)].long()
    slot = (cur + occ) % mr
    # last writer per (vertex, slot) in array order; the rest -> scratch row
    n = ids.shape[0]
    same = (ids[None, :] == ids[:, None]) & (slot[None, :] == slot[:, None])
    later = torch.arange(n, device=ids.device)
    later = later[None, :] > later[:, None]
    last = ~(same & later).any(dim=1)
    wid = torch.where(last, ids, torch.full_like(ids, V))

    def put(table, values):
        ext = torch.cat([table, table.new_zeros((1, mr))])
        ext[wid, slot] = values
        return ext[:V]

    counts = torch.zeros(V + 1, dtype=torch.int32, device=ids.device)
    counts.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
    cursor = (state.nbr_cursor + counts[:V]) % (2 ** 30)
    return state._replace(nbr_ids=put(state.nbr_ids, nbrs),
                          nbr_ts=put(state.nbr_ts, tss),
                          nbr_eid=put(state.nbr_eid, eids),
                          nbr_cursor=cursor)


def updater_order(B: int, device) -> torch.Tensor:
    """Chronological positions for the concat([src, dst]) layout."""
    a = torch.arange(B, device=device)
    return torch.cat([2 * a, 2 * a + 1])


def _occurrence_index(ids: torch.Tensor,
                      order: torch.Tensor | None = None) -> torch.Tensor:
    """occ[i] = number of j with ids[j]==ids[i] and order[j] < order[i].
    O(B^2) compare — B is a processing micro-batch."""
    if order is None:
        order = torch.arange(ids.shape[0], device=ids.device)
    same = ids[None, :] == ids[:, None]
    before = order[None, :] < order[:, None]
    return (same & before).sum(dim=1)


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
