"""The benchmark's spec and yardstick: every cell resolves to its files, the
names keep to their characters, and the frozen counts give the program's
own numbers."""
import json
import re
from pathlib import Path

import pytest

from tgnbench import counts, harness
from tgnbench.reference import family
from tgnbench.small import TEACHER, bench, load_cell

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS + [TEACHER])
def test_cell_resolves_to_its_files(cell):
    c = load_cell(cell)
    wl, cfg = c["workload"], c["config"]
    conf = {x["name"]: x for x in bench()["configs"]}[wl["config"]]
    assert conf["file"].startswith("tgnbench/")
    assert cfg["name"] == wl["config"]
    assert c["mix"]["name"] == wl["traffic"]
    assert set(c["limits"]) == {"emb_err", "state_err", "state_mismatch"}
    assert family(cfg["reference"]).embed
    assert [m["name"] for m in c["end_to_end"]] == [
        "edges_per_s", "round_p95_ms", "setup_s"]
    assert c["per_layer"]
    for m in c["per_layer"]:
        assert callable(harness.reader(m["name"]))
        assert m["moves"] in {x["name"] for x in c["end_to_end"]}


def test_spec_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in SPEC["configs"]] + CELLS
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in CELLS
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for w in SPEC["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert layers == {"session", "step", "kernels", "device"}
    assert TEACHER not in CELLS
    with pytest.raises(ValueError):
        harness.load_cell("../BENCHMARK")


def _student():
    return harness.load_cell("student-fleet64-b600")["config"]


def _teacher():
    return load_cell(TEACHER)["config"]


@pytest.mark.parametrize("rows,bound_us", [(400, 3.249), (3200, 25.994)])
def test_fused_step_bound_is_chip_smokes(rows, bound_us):
    nbytes, other, products = counts.fused_step(_student(), rows)
    # chip_smoke holds every operation to the fp32 rate
    assert round(counts.bound_s(nbytes, other + products) * 1e6, 3) \
        == bound_us
    # the roofline holds the products to 3xTF32's rate; they still bound
    # it: the bytes prune-then-fetch reads take less
    least = counts.bound_s(nbytes, other, products)
    assert least == products / counts.PEAK_PRODUCTS
    assert bound_us / 2.5 < least * 1e6 < bound_us / 2


def test_macs_are_the_programs():
    from repro_torch.core import complexity

    for cfg, macs in ((_student(), 270_900), (_teacher(), 958_800)):
        keys = ("f_mem", "f_time", "f_edge", "f_emb", "m_r", "attention",
                "encoder", "prune_k", "lut_entries")
        want = complexity.stage_macs(complexity.ComplexityConfig(
            **{k: cfg[k] for k in keys}))["total"]
        assert counts.stage_macs(cfg) == want == macs


def test_teacher_products_count_its_flops():
    cfg = _teacher()
    flops = sum(c * 2 * m * k * n for c, m, k, n in counts.products(cfg, 1200))
    assert flops == 2 * 1200 * (472 * 300 + 100 * 300 + 200 * 100
                                + 2 * 10 * 372 * 100 + 200 * 100
                                + 2 * 2 * 50 * 10)
    assert counts.products_bound_s(cfg, 1200, 64) >= (
        64 * flops / counts.PEAK_PRODUCTS)
