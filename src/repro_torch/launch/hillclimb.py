"""§Perf hillclimb: trace named variants of a dry-run cell and print the
roofline deltas (hypothesis -> change -> before -> after).

Port of ``repro.launch.hillclimb``, on the port's dry run
(``launch/dryrun.py``) and config fields:

    PYTHONPATH=src python -m repro_torch.launch.hillclimb qwen3_8b \\
        train_4k baseline H1 H1+H2 [--device cpu]

Variants (composable with '+'):
    baseline   paper-faithful execution (naive autodiff attention, SP carry)
    H1         flash-style rematted attention backward (attn_remat=True)
    H2         Megatron-SP block schedule (gather once per block)
    H3         no sequence parallelism (replicated carry — control arm)
    O1         serving weights stored bf16 (params_bf16)
    O2         positional KV pruning to 4,096 keys (kv_prune_keep)
    O4         no fp32 copy of the decode cache (decode_upcast=False)
    O5         unrolled decode blocks (decode_unroll=True)

Records and traces go to ``results/hillclimb_torch/``, apart from the
reference's ``results/hillclimb/``.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch import configs
from repro_torch.launch import dryrun

OUT_DIR = os.path.join("results", "hillclimb_torch")


def variant_spec(cell_arch: str, names: str):
    """``(cfg, activation rules, run_cell kwargs)`` of a variant."""
    spec = configs.get(cell_arch)
    cfg = spec.config()
    rules = {}
    kwargs = {}
    parts = set(names.split("+")) - {"baseline"}
    if "H1" in parts:
        cfg = cfg.replace(attn_remat=True)
    if "H2" in parts:
        rules["block_in"] = (None, None, None)
    if "H3" in parts:
        rules["carry"] = (None, None, None)  # overrides the default
    if "O1" in parts:
        kwargs["params_bf16"] = True
    if "O2" in parts:
        cfg = cfg.replace(kv_prune_keep=4096)
    if "O4" in parts:
        cfg = cfg.replace(decode_upcast=False)
    if "O5" in parts:
        cfg = cfg.replace(decode_unroll=True)
    return cfg, rules, kwargs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("variants", nargs="*", default=["baseline"])
    ap.add_argument("--device", default=None,
                    help="the mesh's device type: cuda (default) or cpu")
    args = ap.parse_args(argv)
    arch, shape = args.arch, args.shape
    os.makedirs(OUT_DIR, exist_ok=True)
    rows = []
    try:
        for name in args.variants or ["baseline"]:
            cache = os.path.join(OUT_DIR, f"{arch}__{shape}__{name}.json")
            if os.path.exists(cache):
                with open(cache) as f:
                    r = json.load(f)
                print(f"[cached] {name}")
            else:
                cfg, rules, kwargs = variant_spec(arch, name)
                trace_path = os.path.join(
                    OUT_DIR, f"{arch}__{shape}__{name}.trace.json.gz")
                print(f"[trace] {name} ...", flush=True)
                r = dryrun.run_cell(arch, shape, override_cfg=cfg,
                                    extra_rules=rules, save_hlo=trace_path,
                                    device=args.device, **kwargs)
                with open(cache, "w") as f:
                    json.dump(r, f, indent=2)
            rows.append((name, r))
    finally:
        dryrun.destroy_world()

    print(f"\n=== {arch} x {shape}: roofline terms (per-device seconds) ===")
    print(f"{'variant':14s}{'compute':>10s}{'memory':>10s}"
          f"{'collective':>11s}  {'bound':10s}{'step_opt':>9s}")
    for name, r in rows:
        if r["status"] != "ok":
            print(f"{name:14s} {r['status']}")
            continue
        rl = r["roofline"]
        step = max(rl["compute_s"], rl["memory_s"], rl["collective_s"])
        print(f"{name:14s}{rl['compute_s']:10.3f}{rl['memory_s']:10.3f}"
              f"{rl['collective_s']:11.3f}  {rl['bound']:10s}{step:9.3f}")
    return rows


if __name__ == "__main__":
    main()
