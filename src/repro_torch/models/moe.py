"""Token-choice top-k Mixture-of-Experts with static-capacity dispatch, the
port of ``repro.models.moe``.

  1. route: top-k over router logits -> (T, k) expert ids + normalized probs
  2. rank each (token, k) assignment within its expert via a stable sort
  3. scatter token indices into a (E, C) dispatch table (capacity-drop:
     assignments ranked beyond C are dropped; C = ceil(T*k/E *
     capacity_factor) rounded to 128)
  4. gather tokens -> (E, C, D), run the expert FFNs as batched einsums
  5. combine: each token sums its k expert rows, weighted by routing probs.

The integer tables (``dispatch``, ``keep``, ``rank``) equal the reference's
exactly. The combine is a gather, summed over a token's k slots in slot
order from zero: what the reference's scatter-add computes on the CPU, and
deterministic on the card, where an atomic ``index_add_`` is not.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import partitioned
from repro_torch.models.layers import dense_init, gelu
from repro_torch.utils import round_up


def init_moe(generator: torch.Generator, d: int, f: int, n_experts: int,
             device, stack: tuple = ()) -> dict:
    return {
        "router": dense_init(generator, (d, n_experts), device, stack=stack),
        "w_gate": dense_init(generator, (n_experts, d, f), device,
                             stack=stack),
        "w_up": dense_init(generator, (n_experts, d, f), device, stack=stack),
        "w_down": dense_init(generator, (n_experts, f, d), device,
                             stack=stack),
    }


def capacity(n_tokens: int, n_experts: int, top_k: int,
             factor: float = 1.25) -> int:
    return round_up(max(int(n_tokens * top_k / n_experts * factor), 128), 128)


def route(router: torch.Tensor, x: torch.Tensor, top_k: int):
    """x (T, D) -> (expert_idx (T,k) int32, probs (T,k) fp32).

    Probs are softmax over the selected logits (Mixtral/DBRX-style
    renormalization). ``jax.lax.top_k`` keeps the lower index among tied
    logits and ``torch.topk`` promises no order, so tied router logits may
    pick another expert than the reference."""
    logits = x.float() @ router.float()
    top_logits, idx = torch.topk(logits, top_k, dim=-1)
    probs = torch.softmax(top_logits, dim=-1)
    return idx.to(torch.int32), probs


def expert_ranks(flat_e: torch.Tensor, n_experts: int):
    """flat_e (n,) int64 expert ids in flat (token, k) order -> (rank (n,)
    of each assignment among the earlier ones to its expert, counts (E,)
    assignments per expert)."""
    n = flat_e.shape[0]
    dev = flat_e.device
    order = torch.sort(flat_e, stable=True).indices        # group by expert
    sorted_e = flat_e[order]
    # tokens per expert (bincount's, at a shape the ids cannot change)
    counts = (flat_e[:, None] == torch.arange(n_experts, device=dev)).sum(0)
    starts = torch.cumsum(counts, 0) - counts              # exclusive prefix
    rank_sorted = torch.arange(n, device=dev) - starts[sorted_e]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    return rank, counts


def build_dispatch(expert_idx: torch.Tensor, n_experts: int, cap: int):
    """expert_idx (T, k) -> (dispatch_tok (E, C) int32 with T as the
    out-of-range "empty" sentinel, keep (T, k) bool, rank (T, k) int32)."""
    T, k = expert_idx.shape
    dev = expert_idx.device
    flat_e = expert_idx.reshape(-1).long()                 # (T*k,)
    rank, _ = expert_ranks(flat_e, n_experts)
    keep = rank < cap
    # scatter token indices into the dispatch table; dropped -> row E
    # (discarded)
    tok_of = torch.arange(T * k, device=dev) // k
    e_safe = torch.where(keep, flat_e, n_experts)
    dispatch = torch.full((n_experts + 1, cap), T, dtype=torch.int32,
                          device=dev)
    dispatch[e_safe, torch.where(keep, rank, 0)] = torch.where(
        keep, tok_of, T).to(torch.int32)
    return (dispatch[:n_experts], keep.reshape(T, k),
            rank.to(torch.int32).reshape(T, k))


def _act(gate: torch.Tensor, act: str) -> torch.Tensor:
    return F.silu(gate) if act == "silu" else gelu(gate)


def moe_ffn(p: dict, x: torch.Tensor, top_k: int, *,
            capacity_factor: float = 1.25, act: str = "silu"
            ) -> torch.Tensor:
    """x (T, D) -> (T, D). See module docstring for the dataflow. Tokens
    sharded over a mesh with the experts split over its ``model`` axis (a
    DTensor) take the partitioned form, which moves each (token, k) row to
    its expert by all-to-all (``distributed/partitioned.moe_ffn``)."""
    if type(x) is not torch.Tensor and partitioned.moe_splits(p, x):
        return partitioned.moe_ffn(p, x, top_k,
                                   capacity_factor=capacity_factor, act=act)
    T, D = x.shape
    E = p["router"].shape[1]
    C = capacity(T, E, top_k, capacity_factor)
    dt = x.dtype

    expert_idx, probs = route(p["router"], x, top_k)
    dispatch, keep, rank = build_dispatch(expert_idx, E, C)

    # gather (E, C, D); the sentinel T reads an explicit zero pad row
    x_pad = torch.cat([x, torch.zeros((1, D), dtype=dt, device=x.device)])
    xd = x_pad[dispatch.long()]                            # (E, C, D)
    out = experts(p, xd, act)

    # combine: each (token, k) slot reads back its expert row and weights it
    rows = out[expert_idx.reshape(-1).long(),
               torch.where(keep.reshape(-1), rank.reshape(-1), 0).long()]
    return combine(rows, probs, keep).to(dt)


def experts(p: dict, xd: torch.Tensor, act: str) -> torch.Tensor:
    """The expert FFNs on their rows: xd (E, C, D) -> (E, C, D)."""
    dt = xd.dtype
    gate = torch.einsum("ecd,edf->ecf", xd, p["w_gate"].to(dt))
    up = torch.einsum("ecd,edf->ecf", xd, p["w_up"].to(dt))
    hidden = _act(gate, act) * up
    return torch.einsum("ecf,efd->ecd", hidden, p["w_down"].to(dt))


def combine(rows: torch.Tensor, probs: torch.Tensor, keep: torch.Tensor
            ) -> torch.Tensor:
    """Each token's k expert rows (T*k, D), weighted by its routing probs
    and summed in slot order from zero: (T, D) fp32."""
    T, top_k = keep.shape
    flat_w = probs.reshape(-1) * keep.reshape(-1)
    contrib = (rows.float() * flat_w[:, None]).reshape(T, top_k, -1)
    # a dropped slot adds nothing (the reference sends it to a discarded row)
    contrib = torch.where(keep[..., None], contrib, 0.0)
    y = torch.zeros((T, contrib.shape[-1]), dtype=torch.float32,
                    device=rows.device)
    for j in range(top_k):
        y = y + contrib[:, j]
    return y


def moe_ffn_ref(p: dict, x: torch.Tensor, top_k: int, *,
                act: str = "silu") -> torch.Tensor:
    """Dense oracle (no capacity drops): every expert runs on every token,
    combined by routing probs. With generous capacity the dispatch path
    must match it."""
    T, D = x.shape
    dt = x.dtype
    expert_idx, probs = route(p["router"], x, top_k)
    gate = torch.einsum("td,edf->tef", x, p["w_gate"].to(dt))
    up = torch.einsum("td,edf->tef", x, p["w_up"].to(dt))
    hidden = _act(gate, act) * up
    out = torch.einsum("tef,efd->ted", hidden, p["w_down"].to(dt))
    E = p["router"].shape[1]
    # a token's k experts are distinct, so each weight is written once
    w = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    w.scatter_(1, expert_idx.long(), probs)
    return torch.einsum("te,ted->td", w.to(dt), out)
