"""Temporal neighbor pruning (§III-B): score-then-fetch.

Port of ``repro.core.pruning``. SAT logits depend only on timestamps, so
the top-k neighbor subset is known before any feature/memory gather.
"""
from __future__ import annotations

import torch

from repro_torch.utils import NEG_INF

__all__ = ["NEG_INF", "topk_select", "masked_softmax"]


def topk_select(logits: torch.Tensor, valid: torch.Tensor, k: int):
    """Select the k highest-logit valid neighbors.

    logits, valid: (B, m_r). Returns (idx (B, k) int64, sel_logits (B, k)
    with NEG_INF where invalid, sel_valid (B, k) bool).

    Ties keep the lowest index first, as ``jax.lax.top_k`` does (column 0
    is the most recent slot; all-invalid rows tie at NEG_INF on every slot).
    ``torch.topk`` promises no order among ties, so this is a stable
    descending sort cut to k.
    """
    masked = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    sel_logits, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    idx = idx[:, :k]
    return idx, sel_logits[:, :k].contiguous(), torch.gather(valid, 1, idx)


def masked_softmax(logits: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Softmax over valid entries; rows with zero valid entries give zeros."""
    masked = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    # the shift is detached, as the reference stops its gradient; no value
    # changes
    m = masked.max(dim=-1, keepdim=True).values.detach()
    e = torch.exp(masked - m) * valid
    z = e.sum(dim=-1, keepdim=True)
    return torch.where(z > 0, e / z.clamp(min=1e-30), torch.zeros_like(e))
