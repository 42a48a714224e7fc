"""Elastic scaling: resume the same logical job on a different topology.

Port of ``repro.distributed.elastic``. Checkpoints hold whole logical
arrays (``checkpoint.py``) and shardings are a pure function of the
parameter tree and the mesh (``sharding.py``), so changing the device
count is: build the new mesh, recompute the specs, restore with the new
shardings. ``remesh`` does the same for live tensors, through the host
as the reference's ``device_get`` / ``device_put`` does.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree as tree_mod
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import sharding as shd

Tree = Any


def _to_host(x) -> torch.Tensor:
    """A leaf's logical value on the host (a placed leaf reassembled)."""
    if isinstance(x, shd.ShardedTensor):
        return x.full("cpu")
    return x.detach().to("cpu", copy=True)


def remesh(tree: Tree, new_mesh, spec_tree: Tree) -> Tree:
    """Move live tensors onto a new mesh with new specs, a leaf at a time
    through the host."""
    shardings = shd.make_shardings(new_mesh, spec_tree)
    return tree_mod.map(lambda x, s: s.place(_to_host(x)), tree, shardings)


def resume(root: str, tree_like: Tree, new_mesh, mode: str,
           step: int | None = None):
    """Restore a checkpoint onto ``new_mesh`` (any compatible topology):
    ``(tree, meta)``."""
    n_model = new_mesh.shape.get("model", 1)
    specs = shd.param_specs(tree_like, mode, n_model)
    shardings = shd.make_shardings(new_mesh, specs)
    return ckpt.restore(root, tree_like, step=step, shardings=shardings)
