"""Simplified temporal Attention (SAT, Eq. 16) — the student aggregator.

Port of the SAT half of ``repro.core.attention``:

    alpha'(u) = softmax(a + W_t dt^u)            logits from timestamps ONLY
    h_i = W_out [f'_i || h~_i] + b_out           output transform

followed by top-k pruning (core/pruning.py) and a V-projection of just the
surviving neighbors (core/stages.py).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.utils import FrozenConfig
from repro_torch.core.memory import dense_init


@dataclasses.dataclass(frozen=True)
class AttnConfig(FrozenConfig):
    f_mem: int = 100
    f_feat: int = 0          # static node feature dim (0 on Wikipedia/Reddit)
    f_edge: int = 172
    f_time: int = 100
    f_emb: int = 100
    m_r: int = 10            # neighbor buffer width
    prune_k: int | None = None   # SAT pruning budget; None = keep all m_r

    @property
    def d_kv_in(self) -> int:
        return self.f_mem + self.f_edge + self.f_time


def init_feat_proj(generator: torch.Generator, cfg: AttnConfig,
                   device) -> dict:
    p = {}
    if cfg.f_feat > 0:
        p["w_s"] = dense_init(generator, (cfg.f_feat, cfg.f_mem), device)
        p["b_s"] = torch.zeros((cfg.f_mem,), device=device)
    return p


def feat_proj(params: dict, s: torch.Tensor,
              f: torch.Tensor | None) -> torch.Tensor:
    """f'_i = s_i + W_s f_i + b_s   (Eq. 11; identity when f_feat == 0)."""
    if "w_s" in params and f is not None:
        return s + f @ params["w_s"] + params["b_s"]
    return s


def init_sat(generator: torch.Generator, cfg: AttnConfig, device) -> dict:
    d = cfg.f_emb
    return {
        "feat": init_feat_proj(generator, cfg, device),
        "a": torch.zeros((cfg.m_r,), device=device),   # shared logit vector
        "w_t": dense_init(generator, (cfg.m_r, cfg.m_r), device, scale=0.01),
        "w_v": dense_init(generator, (cfg.d_kv_in, d), device),
        "b_v": torch.zeros((d,), device=device),
        "w_out": dense_init(generator, (cfg.f_mem + d, cfg.f_emb), device),
        "b_out": torch.zeros((cfg.f_emb,), device=device),
    }


def sat_logits(params: dict, dt_nbr: torch.Tensor) -> torch.Tensor:
    """alpha-bar' = a + W_t dt (Eq. 16), dt log1p-compressed as in the
    reference."""
    dtf = torch.log1p(dt_nbr.clamp(min=0.0))
    return params["a"] + dtf @ params["w_t"].T
