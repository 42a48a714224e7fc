"""Chronological Updater (§IV-B): vectorized last-write-wins commit.

Port of ``repro.core.updater``. Per processing batch, for each vertex the
batch touches exactly the chronologically-last update survives. Winners
have unique vertex ids, so the commit scatter is collision-free.
"""
from __future__ import annotations

import torch


def last_write_wins(ids: torch.Tensor, valid: torch.Tensor | None = None,
                    order: torch.Tensor | None = None) -> torch.Tensor:
    """Winner mask: True where row i is the chronologically-last valid
    occurrence of ids[i]. ``order`` gives each row's chronological position
    (defaults to array order); ``valid`` rows excluded from the race.

    ``ids`` is (n,), or (T, n) for a cohort of T tenants: the race then
    runs within each tenant's block of n rows, as a (T, n, n) compare, so
    rows of different tenants are never compared."""
    n = ids.shape[-1]
    if order is None:
        order = torch.arange(n, device=ids.device)
    if valid is None:
        valid = torch.ones(ids.shape, dtype=torch.bool, device=ids.device)
    same = (ids[..., None, :] == ids[..., :, None]) & valid[..., None, :]
    eff = torch.where(same, order, torch.full_like(same, -1,
                                                   dtype=order.dtype))
    last = eff.max(dim=-1).values
    return (order == last) & valid


def last_write_wins_sorted(ids: torch.Tensor,
                           valid: torch.Tensor | None = None,
                           order: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """``last_write_wins`` of one (n,) block in O(n log n): rows sorted by
    (id, chronological order), the last row of each id group wins. Invalid
    rows take the int32 maximum as their id, a group that never wins.
    torch has no ``lexsort``, so the order is two stable sorts: by
    ``order``, then by id."""
    n = ids.shape[0]
    if order is None:
        order = torch.arange(n, device=ids.device)
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=ids.device)
    sentinel = torch.iinfo(torch.int32).max
    sent = torch.where(valid, ids, torch.full_like(ids, sentinel))
    by_order = torch.sort(order, stable=True).indices
    perm = by_order[torch.sort(sent[by_order], stable=True).indices]
    sorted_ids = sent[perm]
    next_differs = torch.cat([sorted_ids[1:] != sorted_ids[:-1],
                              torch.ones((1,), dtype=torch.bool,
                                         device=ids.device)])
    out = torch.zeros((n,), dtype=torch.bool, device=ids.device)
    out[perm] = next_differs & (sorted_ids != sentinel)
    return out


def interleave_order(B: int, device) -> torch.Tensor:
    """Chronological positions for the concat([src, dst]) row layout: edge
    e's src row precedes its dst row, edges in batch order."""
    a = torch.arange(B, device=device)
    return torch.cat([2 * a, 2 * a + 1])


def commit_(table: torch.Tensor, ids: torch.Tensor, values: torch.Tensor,
            winners: torch.Tensor) -> torch.Tensor:
    """Scatter winner rows into ``table`` IN PLACE and return it. The
    table's last row is a scratch row (``mailbox.stack_states``) that the
    losers write, which keeps the scatter collision-free for real rows and
    free of host syncs."""
    safe_ids = torch.where(winners, ids.long(), table.shape[0] - 1)
    table[safe_ids] = values.to(table.dtype)
    return table


def commit(table: torch.Tensor, ids: torch.Tensor, values: torch.Tensor,
           winners: torch.Tensor) -> torch.Tensor:
    """``commit_`` into a copy of ``table`` (V, ...) extended by a scratch
    row at index V, which is sliced off: a new table."""
    ext = torch.cat([table, table.new_zeros((1,) + tuple(table.shape[1:]))])
    return commit_(ext, ids, values, winners)[:table.shape[0]]


def commit_scalar(table: torch.Tensor, ids: torch.Tensor,
                  values: torch.Tensor, winners: torch.Tensor
                  ) -> torch.Tensor:
    """``commit`` for (V,)-shaped tables, the reference's name for it."""
    return commit(table, ids, values, winners)
