"""The cells at a size a test run holds, and a whole run of one on the CPU
(the run command's look for a card is skipped).

The teacher's cell is measured and left out of ``BENCHMARK.json`` for now
(its runs spread too widely for a bound); the tests build it from its
configuration file, as a later benchmark PR enters it."""
import json
import time
from pathlib import Path

from tgnbench import harness

TEACHER = "teacher-fleet64-b600"
CELLS = ("student-fleet64-b600", TEACHER)
#: widths as published, a small graph, 3 tenants of 32 edges, every round
#: after the warm-up checked
SMALL = {"config": {"n_users": 60, "n_items": 20, "n_edges": 3000},
         "mix": {"tenants": 3, "batch": 32, "check_stride": 1,
                 "check_rounds": 8, "trace_rounds": 2, "warmup_rounds": 1}}


def bench() -> dict:
    """``BENCHMARK.json`` with the teacher's cell and its roofline added."""
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({
        "name": "tgn-teacher-wiki", "source": "https://arxiv.org/abs/2006.10637",
        "file": "tgnbench/configs/tgn-teacher-wiki.json", "reduced": []})
    spec["workloads"].append({
        "name": TEACHER, "config": "tgn-teacher-wiki",
        "traffic": "fleet64-b600", "chips": 1})
    spec["per_layer"].append({
        "name": "products_roofline", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "kernels", "moves": "edges_per_s",
        "workloads": [TEACHER]})
    return spec


def load_cell(cell, overrides=None):
    return harness.load_cell(cell, overrides, bench())


def run(cell, seed=20260, overrides=SMALL, trace=False):
    out = harness.run(cell, seed, 0.3, trace, "cpu",
                      t_start=time.perf_counter(), overrides=overrides,
                      bench=bench())
    assert out["_notes"]["error"] is None
    assert out["_notes"]["checked_rounds"] >= 1
    return out
