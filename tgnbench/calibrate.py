"""The readings the output check's limits are set from, in one process on
the card:

    python3 -m tgnbench.calibrate --workload <cell> --seeds 1,2,... \
        --seconds 10 --control-seeds 7,8,9 [--fault <name>]

For each of ``--seeds`` a whole run of the cell (the program, timed and
checked; with ``--fault``, with that fault of ``tgnbench/faults.py``
planted) and for each of ``--control-seeds`` the control: the reference
with its products in TF32 in the program's place, over as many rounds as
the program's runs made (median). One JSON line each; the benchmark's own
runs never run this.
"""
import contextlib
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tgnbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--control-rounds", type=int, default=0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    import torch
    from tgnbench import faults, harness

    if not torch.cuda.is_available():
        print("tgnbench.calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    rounds = []
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        with (faults.plant(args.fault) if args.fault
              else contextlib.nullcontext()):
            out = harness.run(args.workload, seed, args.seconds, False,
                              "cuda", t_start=time.perf_counter())
        notes = out.pop("_notes")
        rounds.append(notes["rounds"])
        print(json.dumps({"kind": args.fault or "program", "seed": seed,
                          **notes,
                          "correct": out["correct"],
                          "metrics": {k: v["value"]
                                      for k, v in out["metrics"].items()},
                          "checks": {k: v["value"]
                                     for k, v in out["checks"].items()}}),
              flush=True)
    n = args.control_rounds or int(statistics.median(rounds))
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        t0 = time.perf_counter()
        got = harness.control(args.workload, seed, n, "cuda")
        print(json.dumps({"kind": "control", "seed": seed, "rounds": n,
                          "seconds": time.perf_counter() - t0,
                          "checks": got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
