"""The port's language-model examples run end to end on the CPU:
``examples/arch_zoo_decode_torch.py`` (every arch's smoke config generates
8 tokens) and ``examples/lm_pretrain_torch.py`` (the 100M preset, two
steps at 1 x 32 tokens, checkpointing off).

Each runs in a subprocess with one OpenMP / MKL thread: with a thread a
core and the other test workers on those cores, every small op's thread
team waits for descheduled threads (the streaming example's test timed
out at 600 s that way).
"""
import os
import subprocess
import sys

from repro_torch import configs

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
ENV = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
       "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def _run(script, *args):
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", script),
         "--device", "cpu", *args], env=ENV, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_arch_zoo_decode_example_runs_on_cpu():
    lines = _run("arch_zoo_decode_torch.py").splitlines()
    assert [ln.split()[0] for ln in lines] == configs.all_archs()
    assert all("tokens=(2, 14)" in ln and "ms/tok" in ln for ln in lines)


def test_lm_pretrain_example_runs_on_cpu():
    out = _run("lm_pretrain_torch.py", "--steps", "2", "--batch", "1",
               "--seq", "32", "--log-every", "1", "--ckpt", "")
    assert "[lm] arch=lm100m" in out
    assert "step 2: loss=" in out and "[lm] final loss" in out
