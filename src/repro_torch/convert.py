"""Carry weights and state across from the reference package.

The reference's parameter tree is nested dicts of arrays; tests hand it
over as numpy arrays (``np.asarray`` of each leaf) and never pass JAX
objects into the port. The converters build the port's tensors on a given
device, and their inverses give numpy back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.mailbox import VertexState


def params_from_reference(tree, device) -> dict:
    """Nested dicts of numpy arrays -> the same dicts of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree), device=device)


def params_to_numpy(tree) -> dict:
    """Inverse of ``params_from_reference``."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def state_from_reference(state, device) -> VertexState:
    """A reference ``VertexState`` (any object with its nine fields, as
    numpy arrays) -> the port's VertexState on ``device``."""
    return VertexState(**{
        f: torch.as_tensor(np.array(getattr(state, f)), device=device)
        for f in VertexState._fields})


def state_to_numpy(state: VertexState) -> dict:
    """Field name -> numpy array."""
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in VertexState._fields}
