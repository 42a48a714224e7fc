"""The co-designed student in plain PyTorch: simplified temporal attention
(SAT) with a look-up-table time encoder and temporal neighbour pruning
(Zhou et al., arXiv:2203.05095, Sections III-A to III-C; Table II's
``+NP(M)`` at k = 4).

* Memory: GRU over the cached mail [s_self, s_other, f_e] and the LUT row
  of dt = mail time - last update, the table folded through the time rows
  of the GRU's input weights.
* Scores from timestamps only: a + W_t log1p(dt) over the m_r ring slots
  (newest first, dt = 0 for an empty slot).
* Pruning: the k highest-scoring valid slots (ties to the lower slot), and
  only their memory and edge features are read.
* Aggregation: softmax over the kept scores of the values
  [s_nbr, e_nbr] W_v + LUT(dt) W_v[time rows] + b_v; then
  h = [s_self, agg] W_out + b_out.

``prepare`` folds the LUT tables from the raw parameters itself.
"""
from __future__ import annotations

import torch

from tgnbench.reference import common


def prepare(params: dict, cfg: dict, precision: str = "fp32") -> dict:
    g, a, lut = params["gru"], params["attn"], params["time"]
    raw = 2 * cfg["f_mem"] + cfg["f_edge"]
    kv = cfg["f_mem"] + cfg["f_edge"]
    return {
        "gru": g, "attn": a, "k": cfg["prune_k"], "raw": raw, "kv": kv,
        "bounds": lut["boundaries"],
        "gru_time": common.mm(lut["table"], g["w_i"][raw:], precision),
        "attn_time": common.mm(lut["table"], a["w_v"][kv:], precision),
    }


def update_memory(prep: dict, tab: common.Tables, rows: torch.Tensor,
                  precision: str):
    g = prep["gru"]
    s = tab.memory[rows]
    dt = tab.mail_ts[rows] - tab.last_update[rows]
    x = (common.mm(tab.mail[rows], g["w_i"][:prep["raw"]], precision)
         + g["b_i"] + common.lut_rows(prep["bounds"], prep["gru_time"], dt))
    s_new = common.gru(g, x, s, precision)
    ok = tab.mail_valid[rows]
    return (torch.where(ok[:, None], s_new, s),
            torch.where(ok, tab.mail_ts[rows], tab.last_update[rows]))


def scores(attn: dict, dt: torch.Tensor) -> torch.Tensor:
    """a + W_t log1p(dt): (R, m_r) from the (R, m_r) time deltas."""
    return attn["a"] + (torch.log1p(dt)[:, None, :] * attn["w_t"]).sum(-1)


def embed(prep: dict, tab: common.Tables, edge_feats: torch.Tensor,
          rows: torch.Tensor, t: torch.Tensor, offset: torch.Tensor,
          precision: str) -> torch.Tensor:
    a = prep["attn"]
    ids, dt, eids, valid = common.neighbours(tab, rows, t)
    logit = scores(a, dt)
    masked = torch.where(valid, logit, torch.full_like(logit, common.NEG_INF))
    keep = torch.sort(masked, dim=1, descending=True,
                      stable=True).indices[:, :prep["k"]]
    ok = torch.gather(valid, 1, keep)
    sel_dt = torch.gather(dt, 1, keep)
    s_nbr = tab.memory[torch.gather(ids, 1, keep) + offset[:, None]]
    e_nbr = edge_feats[torch.gather(eids, 1, keep)]
    kv = torch.cat([s_nbr, e_nbr], dim=-1) * ok[..., None]
    R, k, _ = kv.shape
    v = (common.mm(kv.reshape(R * k, -1), a["w_v"][:prep["kv"]],
                   precision).reshape(R, k, -1)
         + common.lut_rows(prep["bounds"], prep["attn_time"], sel_dt)
         + a["b_v"])
    w = common.masked_softmax(torch.gather(logit, 1, keep), ok)
    agg = (w[..., None] * v).sum(dim=1)
    return (common.mm(torch.cat([tab.memory[rows], agg], dim=-1),
                      a["w_out"], precision) + a["b_out"])
