"""Small shared utilities: constants, config base, device resolution."""
from __future__ import annotations

import dataclasses

import torch

#: Masking value for invalid attention logits — the one definition shared by
#: the torch reference path (core/pruning.py), the plain kernel versions
#: (kernels/ops.py) and the CUDA kernels (kernels/csrc/common.cuh, kNegInf).
NEG_INF = -1e30


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class FrozenConfig:
    """Base class for immutable configs with ``replace``/``asdict``."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run the port on the CPU")
        device = "cuda"
    return torch.device(device)
