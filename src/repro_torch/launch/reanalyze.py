"""Refresh dry-run records from their saved traces with the CURRENT
analyzer: accounting changes need no new trace.

Port of ``repro.launch.reanalyze``; reads ``hlo/<cell>.trace.json.gz``
beside each ``<cell>.json`` that ``launch/dryrun.py --out`` wrote.

    PYTHONPATH=src python -m repro_torch.launch.reanalyze results/dryrun_torch
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import sys

from repro_torch.launch import dryrun, hlo_analysis


def refresh(out_dir: str) -> None:
    for jpath in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(jpath) as f:
            r = json.load(f)
        if r.get("status") != "ok":
            continue
        base = os.path.basename(jpath)[:-5]
        tpath = os.path.join(out_dir, "hlo", base + ".trace.json.gz")
        if not os.path.exists(tpath):
            print(f"[skip] {base}: no saved trace")
            continue
        with gzip.open(tpath, "rt") as f:
            trace = json.load(f)
        stats = hlo_analysis.analyze(trace)
        r["per_device"] = dryrun.per_device(stats)
        r["roofline"] = dryrun.roofline_of(stats)
        r["useful_compute_ratio"] = (r["model_flops_per_device"]
                                     / max(stats["flops"], 1.0))
        with open(jpath, "w") as f:
            json.dump(r, f, indent=2)
        rl = r["roofline"]
        print(f"[ok] {base}: mem={rl['memory_s']:.3f}s "
              f"coll={rl['collective_s']:.3f}s comp={rl['compute_s']:.3f}s "
              f"-> {rl['bound']}")


if __name__ == "__main__":
    refresh(sys.argv[1] if len(sys.argv) > 1 else "results/dryrun_torch")
