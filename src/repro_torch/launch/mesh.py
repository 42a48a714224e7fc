"""Production mesh construction.

Port of ``repro.launch.mesh``. The mesh is the port's single-controller
``tgn_sharding.TenantMesh``: named axes over an array of devices, which
may repeat a device.

Topology (the reference's): 256 chips per pod arranged (data=16,
model=16); the multi-pod mesh adds a leading ``pod`` axis (2 pods = 512
chips). ``model`` carries TP/EP/SP traffic, ``data`` the DP gradient
reduction, ``pod`` the cross-pod gradient all-reduce.

``shard_bytes``: what one device of such a mesh holds of an arch's
parameters and optimizer moments, by the sharding rules alone (a mesh of
``meta`` devices allocates nothing).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.distributed import sharding as shd
from repro_torch.distributed.tgn_sharding import TenantMesh
from repro_torch.models import lm_common
from repro_torch.utils import resolve_device


def make_production_mesh(*, multi_pod: bool = False, devices=None
                         ) -> TenantMesh:
    """(16, 16) over ``("data", "model")``, or (2, 16, 16) over ``("pod",
    "data", "model")``. ``devices``: every visible CUDA device unless
    given; a given list may repeat a device (``["cpu"] * 256``). Raises
    when there are too few."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    if len(devices) < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, found {len(devices)} — pass "
            f"devices= (e.g. ['cpu'] * {n}, or repeats of one card)")
    return TenantMesh(np.asarray(
        [torch.device(d) for d in devices[:n]], dtype=object).reshape(shape),
        axes)


def make_host_mesh(device=None) -> TenantMesh:
    """A (1, 1) mesh over ``("data", "model")`` (the single-pod axis
    names) on ``device``: the card unless the caller names another."""
    return TenantMesh(np.asarray([[resolve_device(device)]], dtype=object),
                      ("data", "model"))


def shard_bytes(cfg, mode: str, mesh: TenantMesh) -> dict:
    """One device's share on ``mesh`` of ``cfg``'s parameters (placed by
    ``sharding.param_specs``) and of AdamW's two fp32 moments (by
    ``sharding.zero1_specs``), in bytes: spec arithmetic over ``meta``
    tensors, nothing allocated."""
    params = lm_common.abstract_params(cfg)
    n_model = mesh.shape["model"]
    return {
        "params": shd.per_device_bytes(
            params, shd.param_specs(params, mode, n_model), mesh),
        "moments": 2 * shd.per_device_bytes(
            params, shd.zero1_specs(params, mode, n_model), mesh,
            itemsize=4)}
