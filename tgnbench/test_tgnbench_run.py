"""The run command's process: it refuses a machine without the card, and
nothing it runs loads JAX or the JAX package."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
       "PYTHONPATH": str(ROOT / "src")}


def test_no_card_exits_with_a_message_and_no_result():
    p = subprocess.run(
        [sys.executable, "-m", "tgnbench.run", "--workload",
         "student-fleet64-b600", "--seed", str(2 ** 31 + 11), "--seconds",
         "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        env={**ENV, "CUDA_VISIBLE_DEVICES": ""}, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "needs 1 CUDA device" in p.stderr


SCRIPT = """
import json, sys, time
from tgnbench import harness
from tgnbench.small import CELLS, SMALL, bench
for cell in CELLS:
    out = harness.run(cell, 5, 0.2, True, "cpu", t_start=time.perf_counter(),
                      overrides=SMALL, bench=bench())
    assert out["correct"], out
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_run_loads_no_jax_module():
    p = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                       capture_output=True, text=True, env=ENV, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "torch" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}
