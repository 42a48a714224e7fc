"""The original TGN-attn in plain PyTorch (Rossi et al., arXiv:2006.10637):
GRU memory, a cosine time encoder and two-head temporal attention over the
m_r most recent neighbours (the teacher of Zhou et al.'s distillation).

* Time encoding: Phi(dt) = cos(omega dt + phi).
* Memory: GRU over [s_self, s_other, f_e, Phi(mail time - last update)].
* Attention: q = [s_self, Phi(0)] W_q + b_q; K and V = [s_nbr, e_nbr,
  Phi(dt)] W_{k,v} + b_{k,v} over every ring slot (empty slots masked);
  per head softmax(q K^T / sqrt(d_head)) V; h = [s_self, heads] W_out +
  b_out.
"""
from __future__ import annotations

import math

import torch

from tgnbench.reference import common


def prepare(params: dict, cfg: dict, precision: str = "fp32") -> dict:
    return {"gru": params["gru"], "attn": params["attn"],
            "time": params["time"], "heads": cfg["n_heads"]}


def phi(time: dict, dt: torch.Tensor) -> torch.Tensor:
    return torch.cos(dt[..., None] * time["omega"] + time["phi"])


def update_memory(prep: dict, tab: common.Tables, rows: torch.Tensor,
                  precision: str):
    g = prep["gru"]
    s = tab.memory[rows]
    dt = tab.mail_ts[rows] - tab.last_update[rows]
    mail = torch.cat([tab.mail[rows], phi(prep["time"], dt)], dim=-1)
    s_new = common.gru(g, common.mm(mail, g["w_i"], precision) + g["b_i"],
                       s, precision)
    ok = tab.mail_valid[rows]
    return (torch.where(ok[:, None], s_new, s),
            torch.where(ok, tab.mail_ts[rows], tab.last_update[rows]))


def embed(prep: dict, tab: common.Tables, edge_feats: torch.Tensor,
          rows: torch.Tensor, t: torch.Tensor, offset: torch.Tensor,
          precision: str) -> torch.Tensor:
    a, time, H = prep["attn"], prep["time"], prep["heads"]
    ids, dt, eids, valid = common.neighbours(tab, rows, t)
    R, m_r = dt.shape
    s_self = tab.memory[rows]
    q = common.mm(torch.cat([s_self, phi(time, torch.zeros_like(t))], -1),
                  a["w_q"], precision) + a["b_q"]
    kv_in = torch.cat([tab.memory[ids + offset[:, None]] * valid[..., None],
                       edge_feats[eids] * valid[..., None],
                       phi(time, dt)], dim=-1).reshape(R * m_r, -1)
    k = (common.mm(kv_in, a["w_k"], precision) + a["b_k"]).reshape(
        R, m_r, H, -1)
    v = (common.mm(kv_in, a["w_v"], precision) + a["b_v"]).reshape(
        R, m_r, H, -1)
    q = q.reshape(R, 1, H, -1)
    att = (q * k).sum(-1) / math.sqrt(q.shape[-1])          # (R, m_r, H)
    w = common.masked_softmax(att.transpose(1, 2), valid[:, None, :])
    heads = (w.transpose(1, 2)[..., None] * v).sum(dim=1).reshape(R, -1)
    return (common.mm(torch.cat([s_self, heads], dim=-1), a["w_out"],
                      precision) + a["b_out"])
