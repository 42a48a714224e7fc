"""Real-time streaming inference on the PyTorch/CUDA port: the paper's
Fig.-5-right experiment, as ``examples/streaming_inference.py`` runs it on
the JAX package.

Processes a temporal-graph stream in wall-clock windows through the port's
streaming engine and reports per-window latency. Runs on the GPU (the
staged tier's CUDA kernels are built at first use); ``--device cpu`` runs
the same windows on the CPU, where the kernels' plain versions run.

    PYTHONPATH=src python examples/streaming_inference_torch.py
    PYTHONPATH=src python examples/streaming_inference_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.core import tgn
from repro_torch.core.pipeline import variant_config
from repro_torch.data import stream, temporal_graph as tgd
from repro_torch.serving.engine import StreamingEngine
from repro_torch.utils import resolve_device

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
device = resolve_device(ap.parse_args().device)

g = tgd.reddit_like(n_edges=4000)
dims = dict(n_nodes=g.cfg.n_nodes, n_edges=g.n_edges, f_edge=172,
            f_mem=32, f_time=32, f_emb=32, m_r=10)
cfg = variant_config("sat+lut+np4", **dims)
params = tgn.init_params(torch.Generator().manual_seed(0), cfg, device)
engine = StreamingEngine.from_variant("sat+lut+np4", params, g.edge_feats,
                                      device=device, **dims)
print("stages:", engine.describe())

# 15-minute windows, capped at 256 edges per window
for batch, (h_src, h_dst) in engine.run(stream.time_window(g, 900.0, 256)):
    pass

s = engine.summary()
print(f"windows processed : {s['batches']}")
print(f"mean latency      : {s['mean_latency_ms']:.2f} ms")
print(f"p99 latency       : {s['p99_latency_ms']:.2f} ms")
print(f"mean H2D transfer : {s['mean_h2d_ms']:.3f} ms")
print(f"throughput        : {s['throughput_eps']:.0f} edges/s")

lat = np.array([m["latency_s"] for m in engine.metrics[1:]]) * 1e3
print(f"latency histogram (ms): min={lat.min():.2f} med={np.median(lat):.2f}"
      f" max={lat.max():.2f}")
