"""The benchmark's own weights, drawn on the device from the run's seed in
one call, in the parameter layout the session takes (the same leaves,
shapes and dtypes as ``repro_torch.core.tgn.init_params`` gives).

Matrices are LeCun-normal (scale 1 / sqrt(fan_in)), biases N(0, 0.1^2) so
that a dropped bias shows, the LUT table N(0, 1), SAT's shared logits N(0,
1) and its W_t N(0, 0.1^2). The LUT's boundaries are the 127 interior
equal-frequency bounds of log-uniform dt over [1, 1e7) s; the cosine
encoder is TGN's fixed one (omega = 10^-linspace(0, 9), phi = 0).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _layout(cfg: dict) -> list:
    """``[(path, shape, scale), ...]`` of the drawn leaves."""
    m, t, d, e = cfg["f_mem"], cfg["f_time"], cfg["f_emb"], cfg["f_edge"]
    mail = 2 * m + e + t
    kv = m + e + t

    def dense(path, n_in, n_out):
        return (path, (n_in, n_out), 1.0 / math.sqrt(n_in))

    out = [dense("gru.w_i", mail, 3 * m), dense("gru.w_h", m, 3 * m),
           ("gru.b_i", (3 * m,), 0.1), ("gru.b_h", (3 * m,), 0.1)]
    if cfg["encoder"] == "lut":
        out.append(("time.table", (cfg["lut_entries"], t), 1.0))
    if cfg["attention"] == "sat":
        out += [("attn.a", (cfg["m_r"],), 1.0),
                ("attn.w_t", (cfg["m_r"], cfg["m_r"]), 0.1)]
    else:
        out += [dense("attn.w_q", m + t, d), ("attn.b_q", (d,), 0.1),
                dense("attn.w_k", kv, d), ("attn.b_k", (d,), 0.1)]
    out += [dense("attn.w_v", kv, d), ("attn.b_v", (d,), 0.1),
            dense("attn.w_out", m + d, d), ("attn.b_out", (d,), 0.1),
            dense("link.w1", 2 * d, d), ("link.b1", (d,), 0.1),
            dense("link.w2", d, 1), ("link.b2", (1,), 0.1)]
    return out


def init(cfg: dict, seed: int, device) -> dict:
    """The parameter tree of configuration ``cfg`` on ``device``."""
    layout = _layout(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(math.prod(s) for _, s, _ in layout),
                       generator=gen, device=device)
    tree: dict = {"attn": {"feat": {}}}
    at = 0
    for path, shape, scale in layout:
        n = math.prod(shape)
        group, leaf = path.split(".")
        tree.setdefault(group, {})[leaf] = flat[at:at + n].reshape(shape) * scale
        at += n
    if cfg["encoder"] == "lut":
        q = np.linspace(0.0, 7.0, cfg["lut_entries"] + 1)[1:-1]
        tree["time"]["boundaries"] = torch.tensor(
            10.0 ** q, dtype=torch.float32, device=device)
    else:
        tree["time"] = {
            "omega": torch.tensor(1.0 / 10.0 ** np.linspace(0, 9, cfg["f_time"]),
                                  dtype=torch.float32, device=device),
            "phi": torch.zeros((cfg["f_time"],), device=device)}
    return tree
