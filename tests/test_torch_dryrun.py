"""The port's dry run (``repro_torch/launch/dryrun.py``), hillclimb and
reanalyze.

The reference's ``hillclimb.py`` sets ``XLA_FLAGS`` to 512 host devices
when imported, which would reach every later JAX test of a worker and
every process it starts; so its ``variant_spec`` runs for every variant
in a subprocess of its own (one thread, as the port's other subprocess
tests), started first and read last, and every variant's config, rules
and keywords must equal the port's. (The dry-run cells themselves are held
against the reference's in ``tests/test_torch_dryrun_reference*.py``.)

Then the CLI: a cell saved with ``--out`` comes back from ``reanalyze``
unchanged, and from cache on a second run; a broken cell is ``FAIL`` and
exits 1; ``hillclimb`` prints its variants' roofline rows; the example
runs; the mesh is ``cuda``-typed unless ``cpu`` is asked for. Meshes here
are ``cpu``-typed fake devices; the process group is destroyed after each
test.
"""
import dataclasses
import gzip
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch import configs
from repro_torch.launch import dryrun, hillclimb, reanalyze
from repro_torch.launch.mesh import make_production_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
VARIANTS = ("baseline", "H1", "H2", "H3", "O1", "O2", "O4", "O5", "H1+H2",
            "H1+H3", "O1+O2+O4+O5")

REF_SCRIPT = r"""
import dataclasses, json, sys
from repro.launch import hillclimb
variants = json.loads(sys.argv[1])
out = {"variants": {}}
for v in variants:
    cfg, rules, kwargs = hillclimb.variant_spec("qwen3_8b", v)
    out["variants"][v] = {
        "cfg": {f.name: repr(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg)},
        "rules": {k: [list(e) if isinstance(e, tuple) else e
                      for e in tuple(p)] for k, p in rules.items()},
        "kwargs": kwargs}
print("RESULT " + json.dumps(out))
"""


def _env():
    env = dict(os.environ, JAX_PLATFORMS="cpu", **ONE_THREAD)
    src = os.path.join(ROOT, "src")
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.pop("XLA_FLAGS", None)
    return env


class _Proc:
    """A subprocess started when the module's tests start, read once."""

    def __init__(self, args, cwd):
        self.proc = subprocess.Popen(
            [sys.executable, *args], env=_env(), cwd=cwd,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.out = None

    def result(self):
        if self.out is None:
            out, err = self.proc.communicate(timeout=600)
            self.out = (self.proc.returncode, out, err)
        return self.out

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()


@pytest.fixture(scope="module", autouse=True)
def procs(tmp_path_factory):
    """The reference's subprocess and the example's, started at once so
    they run while the port's cells trace."""
    started = {
        "reference": _Proc(["-c", REF_SCRIPT, json.dumps(VARIANTS)], ROOT),
        "example": _Proc([os.path.join(ROOT, "examples",
                                       "multipod_dryrun_torch.py"),
                          "--device", "cpu"],
                         tmp_path_factory.mktemp("example"))}
    yield started
    for p in started.values():
        p.kill()


@pytest.fixture(scope="module")
def reference(procs):
    """The reference's results."""
    got = {}

    def result():
        if not got:
            code, out, err = procs["reference"].result()
            assert code == 0, err[-3000:]
            line = [x for x in out.splitlines() if x.startswith("RESULT ")]
            got.update(json.loads(line[-1][len("RESULT "):]))
        return got
    return result


@pytest.fixture(autouse=True)
def world():
    yield
    dryrun.destroy_world()


def test_hillclimb_variant_spec_equals_the_reference(reference):
    ref = reference()["variants"]
    for v in VARIANTS:
        cfg, rules, kwargs = hillclimb.variant_spec("qwen3_8b", v)
        got = {"cfg": {f.name: repr(getattr(cfg, f.name))
                       for f in dataclasses.fields(cfg)},
               "rules": {k: [list(e) if isinstance(e, tuple) else e
                             for e in p] for k, p in rules.items()},
               "kwargs": kwargs}
        assert got == ref[v], v


def test_cli_saves_reanalyze_returns_it_unchanged(tmp_path, capsys):
    out = str(tmp_path / "dry")
    args = ["--arch", "qwen3_8b", "--shape", "decode_32k", "--device", "cpu",
            "--out", out]
    (rec,) = dryrun.main(args)
    assert rec["status"] == "ok"
    for key in ("trace_s", "memory", "flop_counter", "per_device",
                "roofline", "model_flops_total", "useful_compute_ratio",
                "fits", "folds", "replicated_ops"):
        assert key in rec, key
    assert rec["folds"] == {"blocks": 36}
    assert rec["fits"] is True
    base = "qwen3_8b__decode_32k__1pod"
    path = os.path.join(out, base + ".json")
    assert os.path.exists(os.path.join(out, "hlo", base + ".trace.json.gz"))
    before = open(path).read()
    reanalyze.refresh(out)
    assert json.loads(open(path).read()) == json.loads(before)
    text = capsys.readouterr().out
    assert "=== dry-run: 1 ok, 0 skip, 0 FAIL of 1 cells ===" in text
    assert f"[ok] {base}" in text
    (again,) = dryrun.main(args)                  # from the cache
    assert "[skip cached] qwen3_8b/decode_32k/1pod" in capsys.readouterr(
        ).out and again == json.loads(before)


def test_a_failing_cell_is_fail_and_exits_1(capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "no_such_arch", "--shape", "decode_32k",
                     "--device", "cpu"])
    assert e.value.code == 1
    text = capsys.readouterr().out
    assert "FAIL: KeyError" in text and "0 ok, 0 skip, 1 FAIL" in text


def test_skip_is_the_references_for_full_attention_long_context():
    r = dryrun.run_cell("qwen3_8b", "long_500k", device="cpu")
    assert r["status"] == "skip(full-attn)"


def test_hillclimb_prints_its_variants(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    rows = dict(hillclimb.main(["qwen3_8b", "decode_32k", "baseline", "O1",
                                "--device", "cpu"]))
    assert os.path.isdir(os.path.join("results", "hillclimb_torch"))
    assert not os.path.exists(os.path.join("results", "hillclimb"))
    base, o1 = rows["baseline"], rows["O1"]
    assert base["status"] == o1["status"] == "ok"
    # O1: the parameters stored bf16, half the bytes a device holds
    assert o1["memory"]["param_bytes"] * 2 == base["memory"]["param_bytes"]
    text = capsys.readouterr().out
    assert "=== qwen3_8b x decode_32k: roofline terms" in text


def test_the_mesh_is_cuda_typed_unless_cpu_is_asked_for():
    mesh = make_production_mesh(devices=["meta"] * 256)
    assert dryrun.device_mesh(mesh, "cuda").device_type == "cuda"
    assert dryrun.device_mesh(mesh, "cpu").device_type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dryrun.run_cell("qwen3_8b", "decode_32k",
                            override_cfg=configs.get("qwen3_8b")
                            .smoke_config())


def test_the_example_runs(procs):
    code, out, err = procs["example"].result()
    assert code == 0, err[-3000:]
    head = out[:out.index("\ncollectives:")]
    rec = json.loads(head[head.index("{"):])
    assert rec["arch"] == "gemma3_12b" and rec["shape"] == "decode_32k"
    assert rec["multi_pod"] is True and rec["status"] == "ok"
    assert rec["n_chips"] == 512
    assert "collectives:" in out


def _trace(arch, shape, multi_pod, tmp_path):
    """A smoke-width cell's ``build_cell`` and its trace's ops."""
    cfg = configs.get(arch).smoke_config()
    path = tmp_path / f"{arch}_{shape}.trace.json.gz"
    rec = dryrun.run_cell(arch, shape, multi_pod=multi_pod,
                          override_cfg=cfg, device="cpu", save_hlo=str(path))
    assert rec["status"] == "ok"
    with gzip.open(path, "rt") as f:
        ops = json.load(f)["ops"]
    dryrun.destroy_world()
    return dryrun.build_cell(arch, shape, multi_pod=multi_pod,
                             override_cfg=cfg), ops


def test_no_all_gather_takes_a_cache_leaf_or_a_logits_chunk(tmp_path):
    """The partitioned forms keep gemma3_12b's sequence-sharded K/V caches
    in place in ``decode_32k`` (2 pods): no all-gather takes a cache
    leaf's shard, whole or a layer's view of it; and in qwen3_8b's
    ``train_4k`` no all-gather takes a loss chunk's vocab-sharded logits
    (B / 16, loss_chunk, V / 16)."""
    cell, ops = _trace("gemma3_12b", "decode_32k", True, tmp_path)
    assert any(e.get("coll") == "all_gather_into_tensor" for e in ops)
    assert dryrun.cache_gathers(cell, ops) == []

    cell, ops = _trace("qwen3_8b", "train_4k", False, tmp_path)
    chunk = [256 // 16, cell.cfg.loss_chunk, cell.cfg.vocab // 16]
    assert not [e for e in ops if e.get("coll") == "all_gather_into_tensor"
                and e["in"][0][:2] == [chunk, "f32"]]
