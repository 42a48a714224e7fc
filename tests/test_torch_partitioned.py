"""The partitioned forms of the LM models' sharded sites
(``repro_torch/distributed/partitioned.py``).

Values: one subprocess spawns a ``gloo`` group of 2 processes (one thread
each, ``tests/torch_partitioned_worker.py``) and runs each form on
DTensors placed as the sharding rules place them, against the plain
function on the whole tensors from the same seeded numpy inputs: the SSD
scan within 1e-6 (its gradients within 1e-5), the decode softmax, the
cross-entropy, the embedding lookup and the MoE layer within 1e-5, each
with its gradients, and the caches written in place bit for bit. The
subprocess starts when the file's tests start.

Plain tensors: a forward, a loss and a decode step of every family with a
partitioned site, traced with ``sys.setprofile``, never enter the module.
"""
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from repro_torch import configs, tree
from repro_torch.distributed import partitioned
from repro_torch.models import lm_common

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}

#: each form's checks, by the prefix of their names in the worker's result
FORMS = {"ssd": "ssd ", "decode": "decode ", "xent": "xent ",
         "embed": "embed ", "moe": "moe "}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """The worker's subprocess, started at once and read on first use."""
    env = dict(os.environ, **ONE_THREAD)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = str(tmp_path_factory.mktemp("gloo") / "result.json")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests",
                                      "torch_partitioned_worker.py"),
         str(_free_port()), out],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    got = {}

    def result():
        if not got:
            stdout, stderr = proc.communicate(timeout=300)
            assert proc.returncode == 0, stderr[-4000:]
            line = [x for x in stdout.splitlines() if x.startswith("RESULT ")]
            got.update(json.loads(line[-1][len("RESULT "):]))
        return got
    yield result
    if proc.poll() is None:
        proc.kill()


@pytest.mark.parametrize("form", sorted(FORMS))
def test_form_equals_the_plain_function_over_gloo(form, gloo):
    res = gloo()
    checks = {k: v for k, v in res["worst"].items()
              if k.startswith(FORMS[form])}
    assert checks, form
    assert res["entered"][form] > 0, res["entered"]
    for name, (excess, tol) in checks.items():
        assert excess <= tol, (name, excess, tol)


#: the sites, each of which must be reached by ``_run_families``
SITES = {"ssd_chunked", "decode_attention", "pruned_decode_attention",
         "_xent_sum", "embed", "moe_ffn", "_index_write"}


def _run_families():
    """A loss, a prefill and a decode step of each family with a
    partitioned site, on plain tensors at smoke width."""
    gen = torch.Generator().manual_seed(0)
    for arch, keep in (("mamba2_130m", 0), ("grok_1_314b", 0),
                       ("gemma3_12b", 0), ("qwen3_8b", 4)):
        cfg = configs.get(arch).smoke_config()
        if keep:
            cfg = cfg.replace(kv_prune_keep=keep)
        params = tree.map(lambda t: t.requires_grad_(),
                          lm_common.init_params(gen, cfg, "cpu"))
        batch = lm_common.train_inputs(cfg, 2, 32, abstract=False,
                                       device="cpu")
        lm_common.loss_fn(params, cfg, batch).backward()
        with torch.no_grad():
            mod = lm_common.FAMILIES[lm_common.family_of(cfg)]
            mod.prefill(params, cfg, batch["tokens"])
            dec = lm_common.decode_inputs(cfg, 2, 32, abstract=False,
                                          device="cpu")
            lm_common.decode_fn(params, cfg, dec)


def test_plain_tensors_never_enter_the_partitioned_forms():
    entered, reached = [], set()
    path = os.path.abspath(partitioned.__file__)

    def profile(frame, event, arg):
        if event != "call":
            return
        if frame.f_code.co_filename == path:
            entered.append(frame.f_code.co_name)
        elif frame.f_code.co_name in SITES:
            reached.add(frame.f_code.co_name)

    sys.setprofile(profile)
    try:
        _run_families()
    finally:
        sys.setprofile(None)
    assert reached == SITES
    assert entered == []
