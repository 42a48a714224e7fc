"""Serving entry point: stream a synthetic temporal graph through the port
and report latency/throughput.

Port of the offline ``--mode tgn`` path of ``repro.launch.serve``. One
stream is served by the StreamingEngine. With ``--tenants N`` (or
``--tenant-variants``) the stream is split into N contiguous feeds, one a
tenant, served by the multi-tenant SessionManager: each round issues every
cohort's step in one call, each kernel launched once a cohort over all its
tenants' rows (``--per-cohort``: one launch a cohort, the baseline).
``--tenant-params`` puts tenants on named parameter sets (a name maps to
weights drawn from a seed derived from it; the teacher lane needs one).
Runs on the GPU unless ``--device cpu`` is given.

Examples:
    PYTHONPATH=src python -m repro_torch.launch.serve --kernels fused
    PYTHONPATH=src python -m repro_torch.launch.serve --kernels ref \\
        --edges 800 --batch 100 --f-mem 16 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --dataset gdelt
    PYTHONPATH=src python -m repro_torch.launch.serve --variant teacher \\
        --edges 800 --batch 100 --f-mem 16 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --tenants 4 \\
        --kernels fused
    PYTHONPATH=src python -m repro_torch.launch.serve --kernels fused \\
        --tenant-variants sat+lut+np4,sat+lut+np4+reservoir,teacher \\
        --tenant-params ,,teacher-v1

``--variant`` takes any registry name or alias of
``repro_torch.core.pipeline`` (``teacher``, ``"+SAT"``, ``"+NP(S)"``,
``reservoir``, ...). ``--dataset gdelt`` serves static node features
(f_feat = 200) and no edge features. A fused request outside the fused
step's coverage (static node features, the cosine variants) runs the
staged tier, as in the reference, and the printed stages say so.
"""
from __future__ import annotations

import argparse
import zlib

import torch

from repro_torch.core import tgn
from repro_torch.core.pipeline import variant_config
from repro_torch.data import stream, temporal_graph as tgd
from repro_torch.serving.engine import EngineConfig, StreamingEngine
from repro_torch.serving.session import DEFAULT_PARAMS, SessionManager
from repro_torch.utils import resolve_device


def _tenant_variants(args) -> list:
    return ([v for v in args.tenant_variants.split(",") if v]
            if args.tenant_variants else [args.variant] * args.tenants)


def _tenant_params(args, n: int) -> list:
    """--tenant-params names aligned with the tenant list, padded with the
    default set (an empty entry means the default too)."""
    names = ([p.strip() for p in args.tenant_params.split(",")]
             if args.tenant_params else [])
    if len(names) > n:
        raise SystemExit(f"--tenant-params lists {len(names)} sets for "
                         f"{n} tenants")
    names += [""] * (n - len(names))
    return [p or DEFAULT_PARAMS for p in names]


def _ensure_param_sets(mgr, variants, pnames) -> None:
    """Register every named set the fleet asks for: the CLI has no weight
    files, so a name maps to weights for that tenant's variant drawn from
    a seed derived from the name (the same name, the same weights)."""
    for v, pname in zip(variants, pnames):
        if pname == DEFAULT_PARAMS or pname in mgr.param_store:
            continue
        cfg = mgr._tenant_cfg(v, None, pname)
        seed = zlib.crc32(pname.encode())
        mgr.register_params(pname, tgn.init_params(
            torch.Generator().manual_seed(seed), cfg, mgr.device))
        print(f"registered param set {pname!r} "
              f"(digest {mgr.param_store.digest(pname)}, seed {seed})")


def run_fleet(args, g, cfg, params, device) -> dict:
    """The stream split into one contiguous feed a tenant, served by one
    session."""
    mgr = SessionManager(params, g.edge_feats, g.node_feats, model=cfg,
                         use_kernels=args.kernels,
                         coalesce=not args.per_cohort, device=device)
    variants = _tenant_variants(args)
    pnames = _tenant_params(args, len(variants))
    _ensure_param_sets(mgr, variants, pnames)
    tids = [mgr.add_tenant(v, name=f"t{i}", params=p)
            for i, (v, p) in enumerate(zip(variants, pnames))]
    print("session cohorts:", {k: (c["tenants"], c["tier"])
                               for k, c in mgr.describe().items()})
    span = g.n_edges // len(tids)
    streams = {tid: stream.fixed_count(
        g, args.batch, window=slice(i * span, (i + 1) * span))
        for i, tid in enumerate(tids)}
    for _batches, _outs in mgr.run(streams):
        pass
    summary = mgr.summary()
    print("session summary:", summary)
    return summary


def run_tgn(args) -> dict:
    device = resolve_device(args.device)
    g = tgd.DATASETS[args.dataset](n_edges=args.edges)
    cfg = variant_config(
        args.variant, n_nodes=g.cfg.n_nodes, n_edges=g.n_edges,
        f_edge=g.cfg.f_edge, f_feat=g.cfg.f_feat, f_mem=args.f_mem,
        f_time=args.f_mem, f_emb=args.f_mem, m_r=10)
    params = tgn.init_params(torch.Generator().manual_seed(0), cfg, device)
    if args.tenant_variants or args.tenants > 1:
        return run_fleet(args, g, cfg, params, device)
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
    ap.add_argument("--tenants", type=int, default=1,
                    help="serve N tenants, each a contiguous window of the "
                         "stream, through one SessionManager")
    ap.add_argument("--tenant-variants", default="",
                    help="comma-separated variant a tenant (overrides "
                         "--tenants/--variant); a variant other than the "
                         "session's attention+encoder needs a named set in "
                         "--tenant-params")
    ap.add_argument("--tenant-params", default="",
                    help="comma-separated parameter-set name a tenant "
                         "(empty: the default set)")
    ap.add_argument("--per-cohort", action="store_true",
                    help="one launch a cohort instead of the coalesced "
                         "round (the baseline)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run_tgn(args)


if __name__ == "__main__":
    main()
