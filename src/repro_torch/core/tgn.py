"""TGN configuration, batch output and parameter/state construction.

Port of ``repro.core.tgn``: the config, parameters and state of every
variant of the paper's ladder (Table II), teacher included;
``process_batch`` and ``_embed``, the reference-tier compositions of the
pipeline's stages; and the link-prediction head. The Algorithm-1 body is
``core.pipeline.TGNPipeline.step``.

Variant axes:
  attention: "vanilla" (teacher/baseline) | "sat" (+SAT)
  encoder:   "cosine" | "lut"             (+LUT)
  prune_k:   None | 6 | 4 | 2             (+NP(L/M/S))
  sampler:   "recent" (SAT top-k) | "uniform" | "reservoir"
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as tnf

from repro_torch.utils import FrozenConfig
from repro_torch.core import attention as attn_mod
from repro_torch.core import mailbox, memory, time_encode as te


@dataclasses.dataclass(frozen=True)
class TGNConfig(FrozenConfig):
    n_nodes: int = 10_000
    n_edges: int = 200_000       # edge-feature store capacity
    f_feat: int = 0              # static node features (GDELT: 200)
    f_edge: int = 172            # edge features (Wikipedia/Reddit: 172)
    f_mem: int = 100
    f_time: int = 100
    f_emb: int = 100
    m_r: int = 10
    n_heads: int = 2
    attention: str = "vanilla"   # "vanilla" | "sat"
    encoder: str = "cosine"      # "cosine" | "lut"
    lut_entries: int = 128
    prune_k: int | None = None
    sampler: str = "recent"      # "recent" | "uniform" | "reservoir"
    reservoir_tau: float = 86_400.0  # time-decay scale (s) of the reservoir

    @property
    def gru(self) -> memory.GRUConfig:
        return memory.GRUConfig(f_mem=self.f_mem, f_edge=self.f_edge,
                                f_time=self.f_time)

    @property
    def attn(self) -> attn_mod.AttnConfig:
        return attn_mod.AttnConfig(
            f_mem=self.f_mem, f_feat=self.f_feat, f_edge=self.f_edge,
            f_time=self.f_time, f_emb=self.f_emb, n_heads=self.n_heads,
            m_r=self.m_r, prune_k=self.prune_k)

    @property
    def tables(self) -> mailbox.TableConfig:
        return mailbox.TableConfig(n_nodes=self.n_nodes, f_mem=self.f_mem,
                                   f_edge=self.f_edge, m_r=self.m_r)


class BatchOut(NamedTuple):
    state: mailbox.VertexState
    emb_src: torch.Tensor       # (B, f_emb) embeddings of edge sources
    emb_dst: torch.Tensor       # (B, f_emb) embeddings of edge destinations
    attn_logits: torch.Tensor   # (2B, m_r) pre-softmax scores (distillation)
    nbr_valid: torch.Tensor     # (2B, m_r) neighbor validity
    nbr_dt: torch.Tensor        # (2B, m_r) time deltas


def init_params(generator: torch.Generator, cfg: TGNConfig, device,
                dt_samples=None) -> dict:
    """Random parameters for any variant, drawn from ``generator``.

    The layout is the reference's (nested dicts); the draws are torch's, so
    parity tests load the reference's parameters through
    ``repro_torch.convert.params_from_reference`` instead.
    """
    tcfg = te.TimeEncoderConfig(dim=cfg.f_time, n_entries=cfg.lut_entries)
    d = cfg.f_emb
    init_attn = (attn_mod.init_vanilla if cfg.attention == "vanilla"
                 else attn_mod.init_sat)
    return {
        "gru": memory.init_gru(generator, cfg.gru, device),
        "time": (te.init_cosine(tcfg, device) if cfg.encoder == "cosine"
                 else te.init_lut(generator, tcfg, device,
                                  dt_samples=dt_samples)),
        "attn": init_attn(generator, cfg.attn, device),
        # downstream link predictor (self-supervision; Section II)
        "link": {
            "w1": memory.dense_init(generator, (2 * d, d), device),
            "b1": torch.zeros((d,), device=device),
            "w2": memory.dense_init(generator, (d, 1), device),
            "b2": torch.zeros((1,), device=device),
        },
    }


def init_state(cfg: TGNConfig, device) -> mailbox.VertexState:
    return mailbox.init_state(cfg.tables, device)


# ---------------------------------------------------------------------------
# Embedding step and Algorithm 1 on the reference tier
# ---------------------------------------------------------------------------


def _reference_pipeline(cfg: TGNConfig, device):
    # local import: pipeline imports this module for TGNConfig/BatchOut
    from repro_torch.core import pipeline as pl
    return pl.build_pipeline(cfg, use_kernels=False, device=device)


def _embed(params: dict, cfg: TGNConfig, state: mailbox.VertexState,
           node_feats: torch.Tensor | None, edge_feats: torch.Tensor,
           vids: torch.Tensor, t_query: torch.Tensor):
    """Dynamic embeddings for vertex instances ``vids`` at times
    ``t_query``: the sampler and aggregator of the reference tier.
    Returns (h, logits, valid, dt)."""
    pipe = _reference_pipeline(cfg, vids.device)
    return pipe.embed(params, pipe.prepare(params), state, edge_feats,
                      node_feats, vids, t_query)


def process_batch(params: dict, cfg: TGNConfig, state: mailbox.VertexState,
                  node_feats: torch.Tensor | None, edge_feats: torch.Tensor,
                  src: torch.Tensor, dst: torch.Tensor, eid: torch.Tensor,
                  ts: torch.Tensor,
                  valid: torch.Tensor | None = None) -> BatchOut:
    """One batch of chronologically sorted edges (B,) through the
    reference tier's step. ``valid`` masks padding rows: their state writes
    are dropped (their embeddings are garbage the caller must mask)."""
    pipe = _reference_pipeline(cfg, src.device)
    return pipe.step_fn(params, state, (src, dst, eid, ts, valid),
                        edge_feats, node_feats)


# ---------------------------------------------------------------------------
# Self-supervised temporal link prediction head (Section II)
# ---------------------------------------------------------------------------


def link_score(params: dict, h_u: torch.Tensor,
               h_v: torch.Tensor) -> torch.Tensor:
    x = torch.cat([h_u, h_v], dim=-1)
    x = torch.relu(x @ params["link"]["w1"] + params["link"]["b1"])
    return (x @ params["link"]["w2"] + params["link"]["b2"])[..., 0]


def link_loss(params: dict, out: BatchOut, neg_dst_emb: torch.Tensor):
    """BCE on positive (src, dst) against negative (src, random) pairs."""
    pos = link_score(params, out.emb_src, out.emb_dst)
    neg = link_score(params, out.emb_src, neg_dst_emb)
    loss = (tnf.softplus(-pos).mean() + tnf.softplus(neg).mean()) / 2
    return loss, (pos, neg)
