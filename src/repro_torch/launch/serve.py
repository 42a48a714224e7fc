"""Serving entry point: stream a synthetic temporal graph through the port's
StreamingEngine and report latency/throughput (single tenant, offline).

Port of the single-tenant ``--mode tgn`` path of ``repro.launch.serve``.
Runs on the GPU unless ``--device cpu`` is given.

Examples:
    PYTHONPATH=src python -m repro_torch.launch.serve --kernels fused
    PYTHONPATH=src python -m repro_torch.launch.serve --kernels ref \\
        --edges 800 --batch 100 --f-mem 16 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --dataset gdelt
    PYTHONPATH=src python -m repro_torch.launch.serve --variant teacher \\
        --edges 800 --batch 100 --f-mem 16 --device cpu

``--variant`` takes any registry name or alias of
``repro_torch.core.pipeline`` (``teacher``, ``"+SAT"``, ``"+NP(S)"``,
``reservoir``, ...). ``--dataset gdelt`` serves static node features
(f_feat = 200) and no edge features. A fused request outside the fused
step's coverage (static node features, the cosine variants) runs the
staged tier, as in the reference, and the printed stages say so.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import tgn
from repro_torch.core.pipeline import variant_config
from repro_torch.data import stream, temporal_graph as tgd
from repro_torch.serving.engine import EngineConfig, StreamingEngine
from repro_torch.utils import resolve_device


def run_tgn(args) -> dict:
    device = resolve_device(args.device)
    g = tgd.DATASETS[args.dataset](n_edges=args.edges)
    cfg = variant_config(
        args.variant, n_nodes=g.cfg.n_nodes, n_edges=g.n_edges,
        f_edge=g.cfg.f_edge, f_feat=g.cfg.f_feat, f_mem=args.f_mem,
        f_time=args.f_mem, f_emb=args.f_mem, m_r=10)
    params = tgn.init_params(torch.Generator().manual_seed(0), cfg, device)
    engine = StreamingEngine(EngineConfig(model=cfg, use_kernels=args.kernels),
                             params, g.edge_feats, g.node_feats,
                             device=device)
    print("engine stages:", engine.describe())
    for _batch, _out in engine.run(stream.fixed_count(g, args.batch)):
        pass
    summary = engine.summary()
    print("engine summary:", summary)
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="wikipedia",
                    choices=tuple(tgd.DATASETS))
    ap.add_argument("--edges", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=200)
    ap.add_argument("--f-mem", type=int, default=32)
    ap.add_argument("--variant", default="sat+lut+np4",
                    help="a registry name or alias: vanilla+cosine "
                         "(teacher), sat+cosine (+SAT), sat+lut (+LUT), "
                         "sat+lut+np<k> (+NP(L/M/S), student), "
                         "sat+lut+np4+uniform, sat+lut+np4+reservoir, or "
                         "the grammar <attention>+<encoder>[+np<k>]"
                         "[+<sampler>]")
    ap.add_argument("--kernels", default="staged",
                    choices=("ref", "staged", "fused"),
                    help="kernel tier: torch references, one CUDA kernel "
                         "per unit, or the fused single-pass step")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run_tgn(args)


if __name__ == "__main__":
    main()
