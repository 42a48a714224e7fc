"""Run one cell of the benchmark on the card(s) of this machine:

    python3 -m tgnbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the checkout's root. Prints the result as one JSON line, last on
standard output, and the compared numbers beside their limits as the last
lines on standard error. Exits non-zero, with no result, when the machine
has fewer CUDA devices than the cell asks for, when a JAX module was loaded,
or when the program under test (``src/repro_torch``) is missing.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one process with few threads: the host side of the program is one Python
# thread, and the numpy of the set-up needs no more
for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_v, "1")

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tgnbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a non-negative integer")

    import torch
    from tgnbench import harness

    chips = harness.load_cell(args.workload)["workload"]["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"tgnbench: cell {args.workload} needs {chips} CUDA device(s); "
              f"this machine has {found}. No result: the benchmark does not "
              "run on the CPU.", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t_start=T_START)
    notes = out.pop("_notes")
    if notes["error"] is not None:
        print(notes["error"], file=sys.stderr)
    print(f"tgnbench: {notes['rounds']} rounds ({notes['window_rounds']} in "
          f"the window), {notes['checked_rounds']} checked; the reference "
          f"took {notes['check_s']} s", file=sys.stderr)
    loaded = sorted(set(notes["forbidden"] + harness.forbidden_modules()))
    if loaded:
        print(f"tgnbench: the run's process loaded {loaded}; no result",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
