"""Temporal attention aggregators.

Port of ``repro.core.attention``.

Teacher — vanilla temporal attention (Eq. 11-15), H heads:
    f'_i = s_i + W_s f_i + b_s
    q    = W_q [f'_i || Phi(0)] + b_q
    K, V = W_{k,v} [s_j || e_ij || Phi(dt_j)] + b_{k,v}
    h~_i = softmax(q K^T / sqrt(d_h)) V

Student — Simplified temporal Attention (SAT, Eq. 16):
    alpha'(u) = softmax(a + W_t dt^u)            logits from timestamps ONLY
followed by top-k pruning (core/pruning.py) and a V-projection of just the
surviving neighbors (core/stages.py). The output transform is shared:
    h_i = W_out [f'_i || h~_i] + b_out

The teacher's products are plain torch matmuls, as the reference's are
XLA ops outside any kernel.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.utils import FrozenConfig, per_tenant, tenant_matmul
from repro_torch.core import pruning, time_encode as te
from repro_torch.core.memory import dense_init


@dataclasses.dataclass(frozen=True)
class AttnConfig(FrozenConfig):
    f_mem: int = 100
    f_feat: int = 0          # static node feature dim (0 on Wikipedia/Reddit)
    f_edge: int = 172
    f_time: int = 100
    f_emb: int = 100
    n_heads: int = 2         # teacher heads (TGN default)
    m_r: int = 10            # neighbor buffer width
    prune_k: int | None = None   # SAT pruning budget; None = keep all m_r

    @property
    def d_kv_in(self) -> int:
        return self.f_mem + self.f_edge + self.f_time

    @property
    def d_q_in(self) -> int:
        return self.f_mem + self.f_time


def init_feat_proj(generator: torch.Generator, cfg: AttnConfig,
                   device) -> dict:
    p = {}
    if cfg.f_feat > 0:
        p["w_s"] = dense_init(generator, (cfg.f_feat, cfg.f_mem), device)
        p["b_s"] = torch.zeros((cfg.f_mem,), device=device)
    return p


def feat_proj(params: dict, s: torch.Tensor, f: torch.Tensor | None,
              tenants: int = 1) -> torch.Tensor:
    """f'_i = s_i + W_s f_i + b_s   (Eq. 11; identity when f_feat == 0).
    The product runs each of ``tenants`` blocks of rows on its own
    (``utils.tenant_matmul``)."""
    if "w_s" in params and f is not None:
        return s + tenant_matmul(f, params["w_s"], tenants) + params["b_s"]
    return s


def init_vanilla(generator: torch.Generator, cfg: AttnConfig,
                 device) -> dict:
    d = cfg.f_emb
    return {
        "feat": init_feat_proj(generator, cfg, device),
        "w_q": dense_init(generator, (cfg.d_q_in, d), device),
        "b_q": torch.zeros((d,), device=device),
        "w_k": dense_init(generator, (cfg.d_kv_in, d), device),
        "b_k": torch.zeros((d,), device=device),
        "w_v": dense_init(generator, (cfg.d_kv_in, d), device),
        "b_v": torch.zeros((d,), device=device),
        "w_out": dense_init(generator, (cfg.f_mem + d, cfg.f_emb), device),
        "b_out": torch.zeros((cfg.f_emb,), device=device),
    }


def vanilla_attention(params: dict, cfg: AttnConfig, time_params: dict,
                      s_self: torch.Tensor, f_self: torch.Tensor | None,
                      s_nbr: torch.Tensor, e_nbr: torch.Tensor,
                      dt_nbr: torch.Tensor, valid: torch.Tensor,
                      tenants: int = 1):
    """Teacher aggregator. s_self (B, f_mem); s_nbr (B, m_r, f_mem); e_nbr
    (B, m_r, f_edge); dt_nbr, valid (B, m_r). Returns (h (B, f_emb),
    logits (B, m_r): the head-mean pre-softmax scores, for distillation).
    The products and einsums run each of ``tenants`` blocks of rows on
    its own (``utils.per_tenant``)."""
    B, m_r = dt_nbr.shape
    H = cfg.n_heads
    fp = feat_proj(params["feat"], s_self, f_self, tenants)
    phi0 = te.cosine_encode(time_params, dt_nbr.new_zeros((B,)))
    q = (tenant_matmul(torch.cat([fp, phi0], dim=-1), params["w_q"], tenants)
         + params["b_q"]).reshape(B, H, -1)
    kv_in = torch.cat([s_nbr, e_nbr, te.cosine_encode(time_params, dt_nbr)],
                      dim=-1)
    k = (tenant_matmul(kv_in, params["w_k"], tenants)
         + params["b_k"]).reshape(B, m_r, H, -1)
    v = (tenant_matmul(kv_in, params["w_v"], tenants)
         + params["b_v"]).reshape(B, m_r, H, -1)
    scores = per_tenant(lambda a, b: torch.einsum("bhd,bnhd->bhn", a, b),
                        tenants, q, k) / math.sqrt(q.shape[-1])
    attn = pruning.masked_softmax(scores, valid[:, None, :])
    agg = per_tenant(lambda a, b: torch.einsum("bhn,bnhd->bhd", a, b),
                     tenants, attn, v).reshape(B, -1)
    h = (tenant_matmul(torch.cat([fp, agg], dim=-1), params["w_out"], tenants)
         + params["b_out"])
    return h, scores.mean(dim=1)


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
    reference.

    The product over the m_r slots is an elementwise product and a sum
    over its last axis, so each row's logits are the same whatever rows
    come with it (PyTorch reduces each output of an m_r-long row with the
    same threads in the same order at any row count), where a cuBLAS
    product may pick another algorithm at another row count (an H100 run
    gave rows that differed by an ulp between 400 and 3,200 rows), and a
    tenant in a fleet must equal its solo run bit for bit."""
    dtf = torch.log1p(dt_nbr.clamp(min=0.0))
    return params["a"] + (dtf[..., None, :] * params["w_t"]).sum(dim=-1)


def sat_attention(params: dict, cfg: AttnConfig, time_params: dict,
                  s_self: torch.Tensor, f_self: torch.Tensor | None,
                  s_nbr: torch.Tensor, e_nbr: torch.Tensor,
                  dt_nbr: torch.Tensor, valid: torch.Tensor, *,
                  encoder: str = "cosine", lut_folded: dict | None = None):
    """Student aggregator with prune-then-fetch over pre-gathered full
    buffers (the reference's composition, which its seed oracle calls; the
    engine's stages prune before they gather). s_nbr (B, m_r, f_mem),
    e_nbr (B, m_r, f_edge), dt_nbr and valid (B, m_r). ``encoder``
    "cosine" encodes the kept dt and projects the whole ``[s || e ||
    Phi]``; "lut" adds the LUT folded through ``w_v``'s time rows
    (``lut_folded``, folded here when not given). Returns (h (B, f_emb),
    full logits (B, m_r))."""
    fp = feat_proj(params["feat"], s_self, f_self)
    logits = sat_logits(params, dt_nbr)
    m_r = dt_nbr.shape[1]
    if cfg.prune_k is not None and cfg.prune_k < m_r:
        idx, sel_logits, sel_valid = pruning.topk_select(logits, valid,
                                                         cfg.prune_k)
        rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
        s_sel, e_sel = s_nbr[rows, idx], e_nbr[rows, idx]
        dt_sel = torch.gather(dt_nbr, 1, idx)
        attn = pruning.masked_softmax(sel_logits, sel_valid)
    else:
        s_sel, e_sel, dt_sel = s_nbr, e_nbr, dt_nbr
        attn = pruning.masked_softmax(logits, valid)

    n_se = cfg.f_mem + cfg.f_edge
    if encoder == "lut":
        folded = lut_folded
        if folded is None:
            folded = te.fold_projection(time_params, params["w_v"][n_se:])
        v = (torch.cat([s_sel, e_sel], dim=-1) @ params["w_v"][:n_se]
             + te.lut_encode(folded, dt_sel) + params["b_v"])
    else:
        phi = te.cosine_encode(time_params, dt_sel)
        v = (torch.cat([s_sel, e_sel, phi], dim=-1) @ params["w_v"]
             + params["b_v"])
    agg = torch.einsum("bn,bnd->bd", attn, v)
    h = torch.cat([fp, agg], dim=-1) @ params["w_out"] + params["b_out"]
    return h, logits
