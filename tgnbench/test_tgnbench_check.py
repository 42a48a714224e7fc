"""The output check, driven through a whole run on the CPU at a small size:
the reference agrees with the program on its ref tier and on the cell's own
tier, traced or not."""
import pytest

from tgnbench.small import CELLS, SMALL, run


@pytest.mark.parametrize("tier", ["ref", "cell"])
@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_program(cell, tier):
    ov = SMALL if tier == "cell" else {**SMALL, "config": {
        **SMALL["config"], "tier": "ref"}}
    out = run(cell, overrides=ov)
    assert out["correct"] and out["failed"] == 0
    checks = out["checks"]
    assert checks["emb_err"]["value"] <= 1e-5
    assert checks["state_err"]["value"] <= 1e-5
    assert checks["state_mismatch"]["value"] == 0
    assert list(out)[-2:] == ["checks", "_notes"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_is_checked_too(cell):
    out = run(cell, seed=3, trace=True)
    assert out["correct"]
    assert "issue_ms" in out["metrics"]
    # no device on the CPU: no device metric is read
    assert "step_mfu" not in out["metrics"]
