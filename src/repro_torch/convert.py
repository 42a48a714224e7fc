"""Carry weights, state and optimizer state across from the reference
package.

The reference's parameter trees (the TGN's and the language models') are
nested dicts of arrays; tests hand them over as numpy arrays (``np.asarray``
of each leaf) and never pass JAX objects into the port. The converters
build the port's tensors on a given device, and their inverses give numpy
back. The optimizer state ``{"step", "m"[, "v"]}`` converts both ways, so a
training run of either package continues in the other. A language model's
cache tree (``pos`` int32 with the reference's shape, bf16 or fp32 k/v)
converts as parameters do, so a decode continues in the other.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.mailbox import VertexState
from repro_torch.training.optim import QTensor


def params_from_reference(tree, device) -> dict:
    """Nested dicts of numpy arrays -> the same dicts of tensors, in the
    same dtypes (bf16 leaves through their bit pattern)."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def params_to_numpy(tree) -> dict:
    """Inverse of ``params_from_reference``, except that bf16 leaves come
    back as fp32 arrays (numpy has no bf16; fp32 holds every bf16 value
    exactly)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


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


def _tensor(x, device) -> torch.Tensor:
    """A numpy array as a tensor; a bf16 array (the reference's
    ``ml_dtypes.bfloat16``) through its 16-bit pattern, so the port needs
    no ``ml_dtypes``."""
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(np.array(arr), device=device)


def opt_state_from_reference(state: dict, device) -> dict:
    """A reference optimizer state (numpy leaves; int8 moments as its
    ``QTensor``, bf16 moments as bfloat16 arrays) -> the port's."""
    def moment(m):
        if isinstance(m, dict):
            return {k: moment(v) for k, v in m.items()}
        if hasattr(m, "_fields"):                  # an int8 moment
            return QTensor(_tensor(m.q, device), _tensor(m.scale, device))
        return _tensor(m, device)

    return {k: _tensor(v, device) if k == "step" else moment(v)
            for k, v in state.items()}


def opt_state_to_numpy(state: dict) -> dict:
    """Inverse of ``opt_state_from_reference``: int8 moments stay
    ``QTensor``s (of numpy arrays), and bf16 moments come back as fp32,
    which holds every bf16 value exactly (numpy has no bf16); the caller
    casts them back."""
    def moment(m):
        if isinstance(m, dict):
            return {k: moment(v) for k, v in m.items()}
        if isinstance(m, QTensor):
            return QTensor(*(x.detach().cpu().numpy() for x in m))
        return m.detach().to(torch.float32 if m.dtype == torch.bfloat16
                             else m.dtype).cpu().numpy()

    return {k: moment(v) for k, v in state.items()}

