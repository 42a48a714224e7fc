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
    (defaults to array order); ``valid`` rows excluded from the race."""
    n = ids.shape[0]
    if order is None:
        order = torch.arange(n, device=ids.device)
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=ids.device)
    same = (ids[None, :] == ids[:, None]) & valid[None, :]
    eff = torch.where(same, order[None, :], torch.full_like(same, -1,
                                                           dtype=order.dtype))
    last = eff.max(dim=1).values
    return (order == last) & valid


def interleave_order(B: int, device) -> torch.Tensor:
    """Chronological positions for the concat([src, dst]) row layout: edge
    e's src row precedes its dst row, edges in batch order."""
    a = torch.arange(B, device=device)
    return torch.cat([2 * a, 2 * a + 1])


def commit(table: torch.Tensor, ids: torch.Tensor, values: torch.Tensor,
           winners: torch.Tensor) -> torch.Tensor:
    """Scatter winner rows into ``table`` (V, ...). Losers are redirected to
    a scratch row appended at index V and sliced off, which keeps the
    scatter collision-free for real rows and free of host syncs."""
    V = table.shape[0]
    safe_ids = torch.where(winners, ids.long(),
                           torch.full_like(ids, V, dtype=torch.long))
    ext = torch.cat([table, table.new_zeros((1,) + tuple(table.shape[1:]))])
    ext[safe_ids] = values.to(table.dtype)
    return ext[:V]


def commit_scalar(table: torch.Tensor, ids: torch.Tensor,
                  values: torch.Tensor, winners: torch.Tensor) -> torch.Tensor:
    """commit() for (V,)-shaped tables."""
    return commit(table, ids, values, winners)
