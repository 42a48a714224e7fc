"""Multi-tenant streaming serving on the PyTorch/CUDA port, as
``examples/multi_tenant_serving.py`` runs it on the JAX package.

Four tenants (per-region transaction feeds) share one SessionManager. Two
run the paper's NP(M) student on the fused tier, one samples neighbours
uniformly, one with a time-decayed reservoir. Same-variant tenants form a
cohort whose kernels run once over all its tenants' rows, and a round
issues every cohort in one call fed by one host-to-device copy; each
tenant's trajectory equals its stream served alone. Runs on the GPU (the
kernels are built at first use); ``--device cpu`` runs the kernels' plain
versions.

    PYTHONPATH=src python examples/multi_tenant_serving_torch.py
    PYTHONPATH=src python examples/multi_tenant_serving_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.core import tgn
from repro_torch.core.pipeline import variant_config
from repro_torch.data import stream, temporal_graph as tgd
from repro_torch.serving.session import SessionManager
from repro_torch.utils import resolve_device

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
device = resolve_device(ap.parse_args().device)

g = tgd.reddit_like(n_edges=4000)
dims = dict(n_nodes=g.cfg.n_nodes, n_edges=g.n_edges, f_edge=172,
            f_mem=32, f_time=32, f_emb=32, m_r=10)
cfg = variant_config("sat+lut+np4", **dims)
params = tgn.init_params(torch.Generator().manual_seed(0), cfg, device)

mgr = SessionManager(params, g.edge_feats, model=cfg, use_kernels="fused",
                     device=device)
tenants = {
    mgr.add_tenant(name="emea"): "sat+lut+np4",
    mgr.add_tenant(name="amer"): "sat+lut+np4",
    mgr.add_tenant("sat+lut+np4+uniform", name="apac"): "uniform sampler",
    mgr.add_tenant("sat+lut+np4+reservoir", name="lab",
                   reservoir_tau=3600.0): "reservoir sampler",
}
print("cohorts:")
for variant, info in mgr.describe().items():
    print(f"  {variant:24s} tenants={info['tenants']} tier={info['tier']} "
          f"sampler={info['sampler']}")

# each tenant replays its own slice of the stream (independent feeds)
streams = {tid: stream.fixed_count(g, 200,
                                   window=slice(800 * i, 800 * (i + 1)))
           for i, tid in enumerate(tenants)}
edges = {tid: 0 for tid in tenants}
for batches, outs in mgr.run(streams):
    for tid in outs:
        edges[tid] += int(np.asarray(batches[tid].valid).sum())

s = mgr.summary()
print(f"\nrounds            : {s['rounds']}")
print(f"tenants / cohorts : {s['tenants']} / {s['cohorts']}")
print(f"mean round        : {s['mean_round_ms']:.2f} ms "
      f"({s['launches_per_round']} round call(s) a round)")
print(f"aggregate thpt    : {s['throughput_eps']:.0f} edges/s")
print("\nper-tenant:")
for tid in tenants:
    mem = mgr.state_of(tid).memory
    print(f"  {tid:5s} edges={edges[tid]:5d} "
          f"touched-vertices={int((mem.abs().sum(dim=1) > 0).sum()):6d}")
