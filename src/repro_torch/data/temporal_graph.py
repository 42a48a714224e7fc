"""Synthetic temporal-graph generators shaped like the paper's datasets.

A numpy copy of ``repro.data.temporal_graph``: for the same seed it yields
array-equal graphs. The streams have the statistical properties the paper's
techniques exploit:

  * bipartite user->item interactions (Wikipedia/Reddit are user-page /
    user-subreddit streams),
  * Zipfian endpoint popularity (a few very active vertices),
  * power-law inter-event times (the LUT encoder's equal-frequency bucketing
    premise — Fig. 1 of the paper),
  * LEARNABLE structure: each user/item has a latent preference vector;
    interaction probability follows latent affinity, and edge features are a
    noisy projection of the endpoint latents. Link prediction AP >> 0.5 is
    achievable, so teacher-vs-student accuracy comparisons are meaningful.

``wikipedia_like`` / ``reddit_like`` emit 172-dim edge features and no node
features; ``gdelt_like`` emits 200-dim static node features and no edge
features (Table II's input dimensions).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.utils import FrozenConfig


@dataclasses.dataclass(frozen=True)
class StreamConfig(FrozenConfig):
    n_users: int = 600
    n_items: int = 400
    n_edges: int = 20_000
    f_edge: int = 172
    f_feat: int = 0            # static node feature dim
    latent: int = 16
    zipf_a: float = 1.2        # endpoint popularity skew
    pareto_a: float = 1.1      # inter-event time tail
    t_scale: float = 60.0      # median inter-event seconds
    noise: float = 0.3
    seed: int = 0

    @property
    def n_nodes(self) -> int:
        return self.n_users + self.n_items


@dataclasses.dataclass
class TemporalGraph:
    """A chronological edge stream + feature stores (host numpy)."""
    src: np.ndarray        # (E,) int32 — user ids in [0, n_users)
    dst: np.ndarray        # (E,) int32 — item ids in [n_users, n_nodes)
    ts: np.ndarray         # (E,) float32 — strictly non-decreasing
    edge_feats: np.ndarray # (E, f_edge) float32 (f_edge may be 0)
    node_feats: np.ndarray | None  # (n_nodes, f_feat) or None
    cfg: StreamConfig

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])


def _zipf_choice(rng: np.random.RandomState, n: int, size: int,
                 a: float) -> np.ndarray:
    """Zipf-distributed ids in [0, n) via inverse-rank sampling."""
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** (-a)
    p /= p.sum()
    return rng.choice(n, size=size, p=p)


def generate(cfg: StreamConfig) -> TemporalGraph:
    rng = np.random.RandomState(cfg.seed)
    U, I, E = cfg.n_users, cfg.n_items, cfg.n_edges

    # latent affinity structure
    zu = rng.randn(U, cfg.latent).astype(np.float32) / np.sqrt(cfg.latent)
    zi = rng.randn(I, cfg.latent).astype(np.float32) / np.sqrt(cfg.latent)

    src = _zipf_choice(rng, U, E, cfg.zipf_a).astype(np.int32)
    # each user interacts preferentially with high-affinity items:
    # sample a candidate set and pick by softmax affinity (vectorized)
    n_cand = 8
    cand = _zipf_choice(rng, I, E * n_cand, cfg.zipf_a).reshape(E, n_cand)
    aff = np.einsum("el,ecl->ec", zu[src], zi[cand])
    aff += cfg.noise * rng.randn(E, n_cand).astype(np.float32)
    pick = np.argmax(aff, axis=1)
    dst_item = cand[np.arange(E), pick].astype(np.int32)

    # power-law inter-event times -> strictly increasing timestamps
    gaps = (rng.pareto(cfg.pareto_a, size=E) + 1.0) * cfg.t_scale
    ts = np.cumsum(gaps).astype(np.float32)

    # edge features: noisy projection of endpoint latents (learnable signal)
    if cfg.f_edge > 0:
        proj = rng.randn(2 * cfg.latent, cfg.f_edge).astype(np.float32)
        proj /= np.sqrt(2 * cfg.latent)
        lat = np.concatenate([zu[src], zi[dst_item]], axis=1)
        edge_feats = lat @ proj + cfg.noise * rng.randn(E, cfg.f_edge).astype(
            np.float32)
        edge_feats = edge_feats.astype(np.float32)
    else:
        edge_feats = np.zeros((E, 0), np.float32)

    if cfg.f_feat > 0:
        projn = rng.randn(cfg.latent, cfg.f_feat).astype(np.float32)
        projn /= np.sqrt(cfg.latent)
        node_feats = np.concatenate([zu, zi], axis=0) @ projn
        node_feats = node_feats.astype(np.float32)
    else:
        node_feats = None

    return TemporalGraph(src=src, dst=(dst_item + U).astype(np.int32),
                         ts=ts, edge_feats=edge_feats,
                         node_feats=node_feats, cfg=cfg)


def wikipedia_like(n_edges: int = 20_000, seed: int = 0) -> TemporalGraph:
    return generate(StreamConfig(n_users=600, n_items=400, n_edges=n_edges,
                                 f_edge=172, f_feat=0, seed=seed))


def reddit_like(n_edges: int = 20_000, seed: int = 1) -> TemporalGraph:
    return generate(StreamConfig(n_users=800, n_items=200, n_edges=n_edges,
                                 f_edge=172, f_feat=0, zipf_a=1.4, seed=seed))


def gdelt_like(n_edges: int = 20_000, seed: int = 2) -> TemporalGraph:
    return generate(StreamConfig(n_users=500, n_items=500, n_edges=n_edges,
                                 f_edge=0, f_feat=200, seed=seed))


DATASETS = {"wikipedia": wikipedia_like, "reddit": reddit_like,
            "gdelt": gdelt_like}
