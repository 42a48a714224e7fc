"""Small shared utilities: constants, config base, device resolution,
deterministic kernels."""
from __future__ import annotations

import contextlib
import dataclasses
import os

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


def per_tenant(fn, tenants: int, *xs):
    """``fn(*xs)`` run on each tenant's rows alone: ``xs`` hold ``tenants``
    equal blocks of rows along their first dimension (None passes
    through), ``fn`` sees one block of each at a time, and its results
    (a tensor or a tuple of them) are concatenated along rows.

    A cohort's step must give each tenant's rows the bits they get served
    alone. On the card a cuBLAS product, and the batched product behind
    an einsum over rows, picks its algorithm by the row count, so a
    product over T tenants' rows can round a tenant's rows otherwise; one
    ``torch.bmm`` over the (T, rows, K) view does too (an H100 run: the
    same products differ at T = 2 to 16). Run block by block at the solo
    shape it cannot. A block that does not start on 16 bytes is copied
    first: a solo run's operands are fresh allocations, and cuBLAS also
    picks its kernel by alignment. The rest of a step (elementwise ops,
    gathers, and reductions over a row's own few slots) gives each row
    the same bits at any row count, and runs over every tenant at once."""
    if tenants == 1:
        return fn(*xs)

    def block(x, t):
        n, rem = divmod(x.shape[0], tenants)
        if rem:
            raise ValueError(f"{x.shape[0]} rows do not split into "
                             f"{tenants} tenants")
        b = x[t * n:(t + 1) * n]
        return b if b.data_ptr() % 16 == 0 else b.clone()

    outs = [fn(*(None if x is None else block(x, t) for x in xs))
            for t in range(tenants)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def tenant_matmul(x, w, tenants: int = 1):
    """``x @ w``, each of the ``tenants`` blocks of ``x``'s rows multiplied
    on its own (``per_tenant``)."""
    return per_tenant(lambda a: a @ w, tenants, x)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run the port on the CPU")
        device = "cuda"
    return torch.device(device)


@contextlib.contextmanager
def deterministic():
    """Deterministic kernels inside the block, so a training run and its
    resumption take the same bits: on the card the backward of a gather
    with repeated indices (the token embedding, MoE's dispatch and
    combine) otherwise scatters with atomic adds in no fixed order. cuBLAS
    needs a fixed workspace for it (``CUBLAS_WORKSPACE_CONFIG``, set here
    unless the caller set it, which counts only before CUDA is first
    used)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)
