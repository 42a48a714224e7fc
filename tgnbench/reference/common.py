"""What both TGN families share, in plain PyTorch: the vertex tables, the
chronological last-write-wins commits, the mail, the FIFO neighbour ring and
the GRU memory cell.

The tables hold S tenants at once, tenant s's vertex v at row s*V + v, with
one extra row at the end that a write meant for nobody lands in. Every
product goes through ``mm``, which can round both operands to TF32 first:
that is the lower precision the output check's control runs in.

Semantics (Rossi et al., TGN, Algorithm 1; Zhou et al., Section IV-B):

* a batch's edges are chronological, and edge e's source instance comes
  before its destination instance;
* the memory of every vertex of the batch is updated from its cached mail
  and its memory before the batch; a vertex without mail keeps its memory;
* embeddings read the updated memory and the ring before this batch;
* each vertex keeps as mail the message of its chronologically last
  instance: [own memory, other endpoint's memory, edge features], both
  memories updated;
* each edge is pushed to both endpoints' rings (first in, first out, m_r
  slots, the newest at the slot before the cursor).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1e30


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest), kept as fp32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in fp32, or on TF32-rounded operands."""
    if precision == "tf32":
        a, b = tf32(a), tf32(b)
    elif precision != "fp32":
        raise ValueError(f"unknown precision {precision!r}")
    return a @ b


class Tables(NamedTuple):
    memory: torch.Tensor        # (N + 1, f_mem)
    last_update: torch.Tensor   # (N + 1,)
    mail: torch.Tensor          # (N + 1, 2 f_mem + f_edge)
    mail_ts: torch.Tensor       # (N + 1,)
    mail_valid: torch.Tensor    # (N + 1,) bool
    nbr_ids: torch.Tensor       # (N + 1, m_r) the tenant's own vertex ids
    nbr_ts: torch.Tensor        # (N + 1, m_r), -1 where empty
    nbr_eid: torch.Tensor       # (N + 1, m_r)
    cursor: torch.Tensor        # (N + 1,) next slot, counted mod 2**30


def init_tables(n_rows: int, f_mem: int, f_edge: int, m_r: int,
                device) -> Tables:
    n = n_rows + 1
    z = dict(device=device)
    return Tables(
        memory=torch.zeros((n, f_mem), **z),
        last_update=torch.zeros((n,), **z),
        mail=torch.zeros((n, 2 * f_mem + f_edge), **z),
        mail_ts=torch.zeros((n,), **z),
        mail_valid=torch.zeros((n,), dtype=torch.bool, **z),
        nbr_ids=torch.zeros((n, m_r), dtype=torch.int64, **z),
        nbr_ts=torch.full((n, m_r), -1.0, **z),
        nbr_eid=torch.zeros((n, m_r), dtype=torch.int64, **z),
        cursor=torch.zeros((n,), dtype=torch.int64, **z))


def masked_softmax(logits: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Softmax over the valid entries of the last axis; zeros where a row
    has none."""
    masked = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    e = torch.exp(masked - masked.max(dim=-1, keepdim=True).values) * valid
    z = e.sum(dim=-1, keepdim=True)
    return torch.where(z > 0, e / z.clamp(min=1e-30), torch.zeros_like(e))


def gru(w: dict, x_in: torch.Tensor, s: torch.Tensor,
        precision: str) -> torch.Tensor:
    """GRU cell, gates [r | z | n]; ``x_in`` is the input projection with
    its bias already added."""
    m = s.shape[-1]
    gh = mm(s, w["w_h"], precision) + w["b_h"]
    r = torch.sigmoid(x_in[:, :m] + gh[:, :m])
    z = torch.sigmoid(x_in[:, m:2 * m] + gh[:, m:2 * m])
    n = torch.tanh(x_in[:, 2 * m:] + r * gh[:, 2 * m:])
    return (1.0 - z) * n + z * s


def lut_rows(boundaries: torch.Tensor, table: torch.Tensor,
             dt: torch.Tensor) -> torch.Tensor:
    """Row ``#(boundaries <= dt)`` of ``table`` for each dt."""
    return table[(dt[..., None] >= boundaries).sum(dim=-1)]


def neighbours(tab: Tables, rows: torch.Tensor, t_query: torch.Tensor):
    """The ring of each row, newest first: (ids, time since, edge ids,
    valid), each (R, m_r); the time since an empty slot is 0."""
    m_r = tab.nbr_ids.shape[1]
    col = (tab.cursor[rows][:, None] - 1 - torch.arange(
        m_r, device=rows.device)) % m_r
    ts = tab.nbr_ts[rows[:, None], col]
    valid = ts >= 0.0
    dt = (t_query[:, None] - ts).clamp(min=0.0) * valid
    return (tab.nbr_ids[rows[:, None], col], dt,
            tab.nbr_eid[rows[:, None], col], valid)


def step(family, prep: dict, tab: Tables, batch, edge_feats: torch.Tensor,
         n_nodes: int, precision: str = "fp32"):
    """One round of S tenants' batches through the model of ``family``
    (a module with ``update_memory(prep, tab, rows, precision)`` and
    ``embed(prep, tab, edge_feats, rows, t, offset, precision)``).

    ``batch``: (src, dst, eid, ts), each (S, B), every edge valid; tenant
    s's tables are rows [s V, (s + 1) V). Updates ``tab`` in place and
    returns the embeddings (S, 2, B, f_emb): sources, then destinations.
    """
    src, dst, eid, ts = batch
    S, B = src.shape
    dev = src.device
    dummy = tab.memory.shape[0] - 1
    offset = (torch.arange(S, device=dev) * n_nodes)[:, None]
    rows = (torch.cat([src, dst], dim=1).long() + offset).reshape(-1)
    offset_rows = offset.expand(S, 2 * B).reshape(-1)
    t = torch.cat([ts, ts], dim=1).reshape(-1)
    # chronological position of each instance within its tenant's batch
    pos = torch.cat([2 * torch.arange(B, device=dev),
                     2 * torch.arange(B, device=dev) + 1]).repeat(S)
    last = torch.full((dummy + 1,), -1, dtype=pos.dtype, device=dev)
    last.scatter_reduce_(0, rows, pos, reduce="amax")
    winner = pos == last[rows]

    # memory: every instance of a vertex computes the same update from the
    # state before the batch, so every instance may write it
    s_new, lu_new = family.update_memory(prep, tab, rows, precision)
    tab.memory[rows] = s_new
    tab.last_update[rows] = lu_new

    h = family.embed(prep, tab, edge_feats, rows, t, offset_rows, precision)

    # mail of the last instance of each vertex, from the updated memories
    ms = tab.memory[(src.long() + offset)]
    md = tab.memory[(dst.long() + offset)]
    fe = edge_feats[eid.long()]
    mail = torch.cat([torch.cat([ms, md, fe], dim=-1),
                      torch.cat([md, ms, fe], dim=-1)], dim=1)
    w_rows = torch.where(winner, rows, torch.full_like(rows, dummy))
    tab.mail[w_rows] = mail.reshape(S * 2 * B, -1)
    tab.mail_ts[w_rows] = t
    tab.mail_valid[rows] = True

    # FIFO rings: the n-th push of a vertex in this batch (in chronological
    # order) goes to slot cursor + n; of more than m_r pushes the last m_r
    # survive
    m_r = tab.nbr_ids.shape[1]
    order = torch.argsort(rows * (2 * B) + pos)
    srows = rows[order]
    idx = torch.arange(rows.shape[0], device=dev)
    start = torch.where(torch.cat([torch.ones(1, dtype=torch.bool,
                                              device=dev),
                                   srows[1:] != srows[:-1]]), idx,
                        torch.zeros_like(idx))
    nth = torch.empty_like(idx)
    nth[order] = idx - torch.cummax(start, dim=0).values
    pushes = torch.bincount(rows, minlength=dummy + 1)
    keep = nth >= pushes[rows] - m_r
    slot = (tab.cursor[rows] + nth) % m_r
    k_rows = torch.where(keep, rows, torch.full_like(rows, dummy))
    tab.nbr_ids[k_rows, slot] = torch.cat([dst, src], dim=1).reshape(-1).long()
    tab.nbr_ts[k_rows, slot] = t
    tab.nbr_eid[k_rows, slot] = torch.cat([eid, eid], dim=1).reshape(-1).long()
    tab.cursor.add_(pushes).remainder_(2 ** 30)
    return h.reshape(S, 2, B, -1)
