"""Streaming TGNN inference engine — the paper's accelerator, end to end.

Port of ``repro.serving.engine``: a stateful single-stream session over a
``core.pipeline.TGNPipeline``.

  Edge Parser   -> data.stream.EdgeBatch (chronological, padded, masked)
  prefetch      -> pinned host buffers, non-blocking copies on a side
                   stream (distributed/overlap.py), transfer time recorded
  MUU / EU      -> the pipeline's stages on the chosen kernel tier
                   (ref | staged | fused)
  Updater       -> last-write-wins chronological commit

The engine is a one-tenant view of the multi-tenant session
(``serving/session.py``), as the reference's is: one tenant in a
one-slot cohort, stepped through the same ``batched_step`` as a fleet, so
a stream served alone and the same stream in a fleet give equal results.
The engine runs on ``cuda`` unless it is given ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable

import numpy as np
import torch

from repro_torch.utils import FrozenConfig, resolve_device
from repro_torch.core import pipeline as pl
from repro_torch.core import stages, tgn
from repro_torch.data.stream import EdgeBatch
from repro_torch.distributed import overlap
from repro_torch.obs import Histogram
from repro_torch.serving.session import SessionManager


@dataclasses.dataclass(frozen=True)
class EngineConfig(FrozenConfig):
    model: tgn.TGNConfig = tgn.TGNConfig(attention="sat", encoder="lut",
                                         prune_k=4)     # sat+lut+np4
    # kernel tier: "ref" | "staged" | "fused" (bools accepted — see
    # core/stages.KERNEL_TIERS)
    use_kernels: bool | str = True
    prefetch: int = 2


class StreamingEngine:
    """Stateful streaming inference over a chronological edge stream."""

    def __init__(self, cfg: EngineConfig, params: dict, edge_feats,
                 node_feats=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # a one-tenant session: the same cohort step as a fleet
        self.session = SessionManager(params, edge_feats, node_feats,
                                      model=cfg.model,
                                      use_kernels=cfg.use_kernels,
                                      device=self.device)
        self.tid = self.session.add_tenant()
        cohort = self.session.cohort_of(self.tid)
        self.pipeline = cohort.pipeline
        self.params = cohort.params
        self.edge_feats = self.session.edge_feats
        self.node_feats = self.session.node_feats
        # folded LUT tables and kernel packs, prepared once per session
        self.aux = cohort.aux
        self.metrics: list[dict] = []
        self._state = None           # the last state read or set
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    @property
    def state(self):
        """The tenant's VertexState: a copy, taken after the last step (the
        same object until the next step or assignment)."""
        if self._state is None:
            self._state = self.session.state_of(self.tid)
        return self._state

    @state.setter
    def state(self, st):
        self.session.set_state(self.tid, st)
        self._state = st

    @classmethod
    def from_variant(cls, variant: str, params: dict, edge_feats,
                     node_feats=None, use_kernels=True, prefetch: int = 2,
                     device=None, **dims) -> "StreamingEngine":
        """Engine over a registry variant (``"sat+lut+np4"``,
        ``"teacher"``, Table-II row names such as ``"+NP(S)"``,
        ``"reservoir"``, ...); ``dims`` are TGNConfig table/feature
        fields."""
        model = pl.variant_config(variant, **dims)
        return cls(EngineConfig(model=model, use_kernels=use_kernels,
                                prefetch=prefetch), params, edge_feats,
                   node_feats, device=device)

    def describe(self) -> dict:
        """The pipeline's variant, stages and resolved tier, and the tier
        this engine asked for (its cohort is keyed by the resolved one)."""
        return {**self.pipeline.describe(),
                "use_kernels": stages.kernel_tier(self.cfg.use_kernels)}

    def step_on_device(self, dev: tuple) -> tgn.BatchOut:
        """One pipeline step over batch tensors already on the device
        ``(src, dst, eid, ts, valid)``, WITHOUT committing state and
        without recording metrics (a benchmarking hook). It runs the
        program ``process`` runs, on a copy of the tenant's tables
        (``SessionManager.peek``), so its time is ``process``'s plus one
        device copy of the tables (as the reference's jitted step, whose
        state is not donated, writes whole new tables)."""
        return self.session.peek(self.tid, dev)

    def embed(self, vids: torch.Tensor, t_query: torch.Tensor):
        """``pipeline.embed`` of vertex instances ``vids`` at ``t_query``
        on the tenant's current state (no state update): ``(h, logits,
        full_valid, full_dt)``."""
        cohort = self.session.cohort_of(self.tid)
        return self.pipeline.embed(self.params, self.aux, cohort.view(0),
                                   self.edge_feats, self.node_feats, vids,
                                   t_query)

    def _to_device(self, batch: EdgeBatch) -> overlap.DeviceBatch:
        """Check the batch's ids against the tables, then issue its copy."""
        V, n_rows = self.cfg.model.n_nodes, self.edge_feats.shape[0]
        for name, a, hi in (("src", batch.src, V), ("dst", batch.dst, V),
                            ("eid", batch.eid, n_rows)):
            a = np.asarray(a)
            if a.size and (a.min() < 0 or a.max() >= hi):
                raise ValueError(f"batch {name} out of range [0, {hi})")
        return overlap.to_device(batch, self.device, self._copy_stream)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def process(self, batch: EdgeBatch | overlap.DeviceBatch):
        """Process one batch; returns (emb_src, emb_dst) and records
        latency/throughput/transfer metrics. ``h2d_s`` is the exposed
        transfer cost: issue time plus whatever wait the step incurred."""
        if not isinstance(batch, overlap.DeviceBatch):
            batch = self._to_device(batch)
        t0 = time.perf_counter()
        overlap.join(batch)
        h2d = batch.enq_s + (time.perf_counter() - t0)
        t1 = time.perf_counter()
        out = self.session.step({self.tid: batch.dev})[self.tid]
        self._sync()
        dt = time.perf_counter() - t1
        self._state = None
        n = int(np.asarray(batch.host.valid).sum())
        self.metrics.append({"latency_s": dt, "edges": n, "h2d_s": h2d,
                             "throughput_eps": n / dt if dt > 0 else 0.0})
        return out.emb_src, out.emb_dst

    def run(self, stream: Iterable[EdgeBatch]):
        """Drive the engine over a stream; the next batches' copies are in
        flight while each step runs."""
        for db in overlap.prefetch(iter(stream), self.cfg.prefetch,
                                   device_put=self._to_device):
            yield db.host, self.process(db)

    def summary(self) -> dict:
        """The reference's keys, computed as the reference computes them,
        over every batch after the first (the warm-up batch, which also
        builds the kernels): means and p99 from log-bucketed histograms
        (``obs.Histogram``), throughput as edges over the summed
        latency, and 0.0 where there is no sample."""
        if not self.metrics:
            return {}
        lat = Histogram("engine.latency_s")
        h2d = Histogram("engine.h2d_s")
        for m in self.metrics[1:]:
            lat.record(m["latency_s"])
            h2d.record(m["h2d_s"])
        edges = sum(m["edges"] for m in self.metrics[1:])
        return {
            "batches": len(self.metrics) - 1,
            "mean_latency_ms": (lat.mean() or 0.0) * 1e3,
            "p99_latency_ms": (lat.quantile(0.99) or 0.0) * 1e3,
            "mean_h2d_ms": (h2d.mean() or 0.0) * 1e3,
            "throughput_eps": (float(edges / lat.total)
                               if lat.total > 0 else 0.0),
        }
