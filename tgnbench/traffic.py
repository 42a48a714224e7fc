"""Traffic: the synthetic edge stream and the fleet's replay of it.

``generate`` is a frozen copy of ``repro_torch.data.temporal_graph.generate``
(edge features only): a bipartite user -> item stream with Zipf endpoint
popularity and Pareto inter-event times, at the counts a configuration
gives, from the configuration's fixed ``stream_seed``: like a published
dataset, the stream is the same in every run. ``Replay`` hands every tenant
of a mix one batch a round: tenant i replays the stream from edge
(shift + i * floor(E / tenants)) mod E, the shift drawn from the run's
seed, wrapping around with its timestamps advanced by the stream's span, so
each tenant's stream stays chronological and every batch is full. Every
seed so gets the same edges and batch sizes, in another order.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Graph(NamedTuple):
    src: np.ndarray          # (E,) int32 users in [0, n_users)
    dst: np.ndarray          # (E,) int32 items in [n_users, n_users + n_items)
    ts: np.ndarray           # (E,) float32, non-decreasing
    edge_feats: np.ndarray   # (E, f_edge) float32


def seed32(seed: int, stream: int) -> int:
    """A 32-bit seed for ``stream`` drawn from the run's ``--seed`` (any
    non-negative integer)."""
    return int(np.random.SeedSequence([int(seed), stream]).generate_state(1)[0])


def _zipf_choice(rng, n: int, size: int, a: float) -> np.ndarray:
    p = np.arange(1, n + 1, dtype=np.float64) ** (-a)
    p /= p.sum()
    return rng.choice(n, size=size, p=p)


def generate(n_users: int, n_items: int, n_edges: int, f_edge: int,
             seed: int, latent: int = 16, zipf_a: float = 1.2,
             pareto_a: float = 1.1, t_scale: float = 60.0,
             noise: float = 0.3) -> Graph:
    rng = np.random.RandomState(seed)
    U, I, E = n_users, n_items, n_edges
    zu = rng.randn(U, latent).astype(np.float32) / np.sqrt(latent)
    zi = rng.randn(I, latent).astype(np.float32) / np.sqrt(latent)
    src = _zipf_choice(rng, U, E, zipf_a).astype(np.int32)
    n_cand = 8
    cand = _zipf_choice(rng, I, E * n_cand, zipf_a).reshape(E, n_cand)
    aff = np.einsum("el,ecl->ec", zu[src], zi[cand])
    aff += noise * rng.randn(E, n_cand).astype(np.float32)
    item = cand[np.arange(E), np.argmax(aff, axis=1)].astype(np.int32)
    gaps = (rng.pareto(pareto_a, size=E) + 1.0) * t_scale
    ts = np.cumsum(gaps).astype(np.float32)
    proj = rng.randn(2 * latent, f_edge).astype(np.float32)
    proj /= np.sqrt(2 * latent)
    lat = np.concatenate([zu[src], zi[item]], axis=1)
    feats = (lat @ proj + noise * rng.randn(E, f_edge).astype(np.float32))
    return Graph(src=src, dst=(item + U).astype(np.int32), ts=ts,
                 edge_feats=feats.astype(np.float32))


class Replay:
    """Round r's batch of each tenant: B consecutive edges of its own
    replay of the stream."""

    def __init__(self, g: Graph, tenants: int, batch: int, shift: int = 0):
        self.g = g
        self.E = int(g.src.shape[0])
        self.B = int(batch)
        self.offsets = (int(shift) + np.arange(tenants, dtype=np.int64)
                        * (self.E // tenants)) % self.E
        self.ts64 = g.ts.astype(np.float64)
        # the first edge comes one span after the last one's time origin
        self.span = float(self.ts64[-1])

    def batch(self, r: int, tenants=None):
        """(src, dst, eid, ts) of round ``r``, each (len(tenants), B), for
        ``tenants`` (indices; every tenant by default)."""
        off = self.offsets if tenants is None else self.offsets[tenants]
        p = off[:, None] + r * self.B + np.arange(self.B)
        idx, wraps = p % self.E, p // self.E
        return (self.g.src[idx], self.g.dst[idx], idx.astype(np.int32),
                (self.ts64[idx] + wraps * self.span).astype(np.float32))
