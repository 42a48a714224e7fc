"""Chronological batching of a temporal edge stream (Section II-A setup).

``fixed_count`` forms batches of a fixed number of graph signals, as in
the paper; ``time_window`` batches the edges of consecutive wall-clock
windows (the real-time inference mode). A numpy copy of those parts of
``repro.data.stream`` (array-equal batches for the same seed). Batches
are padded to a fixed shape so one step shape serves the whole stream
(padding rows are masked via eid/valid); each carries sampled negative
destinations for the self-supervised link task.
``chronological_split`` gives the train/val/test windows.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np

from repro_torch.data.temporal_graph import TemporalGraph


class EdgeBatch(NamedTuple):
    src: np.ndarray     # (B,) int32 (padded rows repeat the last edge)
    dst: np.ndarray     # (B,) int32
    eid: np.ndarray     # (B,) int32 — row into the edge-feature store
    ts: np.ndarray      # (B,) float32
    valid: np.ndarray   # (B,) bool — False on padding rows
    neg_dst: np.ndarray # (B,) int32 — sampled negative destinations


def chronological_split(g: TemporalGraph, val: float = 0.15,
                        test: float = 0.15):
    """Return (train_slice, val_slice, test_slice) index ranges."""
    E = g.n_edges
    n_test = int(E * test)
    n_val = int(E * val)
    n_train = E - n_val - n_test
    return slice(0, n_train), slice(n_train, n_train + n_val), \
        slice(n_train + n_val, E)


def _pad(x: np.ndarray, B: int) -> np.ndarray:
    if x.shape[0] == B:
        return x
    reps = np.repeat(x[-1:], B - x.shape[0], axis=0)
    return np.concatenate([x, reps], axis=0)


def fixed_count(g: TemporalGraph, batch_size: int, *,
                window: slice | None = None, seed: int = 0,
                item_range: tuple[int, int] | None = None
                ) -> Iterator[EdgeBatch]:
    """Yield padded fixed-size chronological batches over ``window``."""
    rng = np.random.RandomState(seed)
    lo = (window.start or 0) if window else 0
    hi = window.stop if window and window.stop is not None else g.n_edges
    if item_range is None:
        item_range = (g.cfg.n_users, g.cfg.n_nodes)
    for s in range(lo, hi, batch_size):
        e = min(s + batch_size, hi)
        idx = np.arange(s, e)
        n = idx.shape[0]
        neg = rng.randint(item_range[0], item_range[1],
                          size=batch_size).astype(np.int32)
        yield EdgeBatch(
            src=_pad(g.src[idx], batch_size),
            dst=_pad(g.dst[idx], batch_size),
            eid=_pad(idx.astype(np.int32), batch_size),
            ts=_pad(g.ts[idx], batch_size),
            valid=np.arange(batch_size) < n,
            neg_dst=neg,
        )


def time_window(g: TemporalGraph, window_s: float, max_batch: int, *,
                window: slice | None = None, seed: int = 0
                ) -> Iterator[EdgeBatch]:
    """Yield batches of all edges inside consecutive ``window_s``-second
    windows (padded/truncated to ``max_batch`` — the paper's real-time
    inference mode)."""
    rng = np.random.RandomState(seed)
    lo = (window.start or 0) if window else 0
    hi = window.stop if window and window.stop is not None else g.n_edges
    i = lo
    while i < hi:
        t0 = g.ts[i]
        j = i
        while j < hi and g.ts[j] < t0 + window_s and j - i < max_batch:
            j += 1
        idx = np.arange(i, j)
        n = idx.shape[0]
        neg = rng.randint(g.cfg.n_users, g.cfg.n_nodes,
                          size=max_batch).astype(np.int32)
        yield EdgeBatch(
            src=_pad(g.src[idx], max_batch),
            dst=_pad(g.dst[idx], max_batch),
            eid=_pad(idx.astype(np.int32), max_batch),
            ts=_pad(g.ts[idx], max_batch),
            valid=np.arange(max_batch) < n,
            neg_dst=neg,
        )
        i = j
