"""Shared by ``tests/test_torch_dryrun_cells_*.py``: one dry-run cell of
the port (``repro_torch/launch/dryrun.py``) at an arch's smoke width on a
production mesh over ``cpu``-typed fake devices.

Every arch x shape x mesh must trace ``ok`` or give the reference's
``skip(full-attn)`` (``long_500k`` on a pure full-attention arch); each
record carries ``folds``, ``replicated_ops``, ``fits`` and ``trace_s``;
the DTensor parameters' local bytes equal ``mesh.shard_bytes``' spec
arithmetic, and all the inputs' local bytes the record's
``argument_bytes``. The cells are split over several files, each under a
minute alone. Sequences are cut to ``SEQ`` (the shapes' batches and
meshes are kept; a decode cache of ``SEQ`` still splits over ``model``).
"""
import pytest

from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import lm_common

SEQ = 32
SHAPES = tuple(configs.SHAPES)


@pytest.fixture(scope="module", autouse=True)
def world():
    yield
    dryrun.destroy_world()


def check_cell(arch: str, shape: str, multi_pod: bool) -> None:
    spec = configs.get(arch)
    cfg = spec.smoke_config()
    rec = dryrun.run_cell(arch, shape, multi_pod=multi_pod, override_cfg=cfg,
                          device="cpu", seq_len=SEQ)
    if shape == "long_500k" and not lm_common.supports_long_context(cfg):
        assert rec["status"] == "skip(full-attn)"
        return
    assert rec["status"] == "ok", rec
    for key in ("folds", "replicated_ops", "fits", "trace_s"):
        assert key in rec
    mem = rec["memory"]
    mesh = mesh_mod.make_production_mesh(
        multi_pod=multi_pod, devices=["meta"] * (512 if multi_pod else 256))
    assert mem["param_bytes"] == mesh_mod.shard_bytes(
        cfg, spec.shard_mode, mesh)["params"]
    assert mem["local_argument_bytes"] == mem["argument_bytes"]
    assert mem["peak_bytes"] >= mem["argument_bytes"]
    pd = rec["per_device"]
    assert pd["flops"] > 0 and pd["bytes"] > 0
    assert rec["fits"] == (mem["peak_bytes"] <= 80e9)
