"""Gradient compression: int8 block quantization with error feedback, the
port of ``repro.distributed.compression``.

Two entry points:

  * ``ef_int8_roundtrip`` — quantize -> dequantize of a gradient tree with
    an error-feedback residual (EF-SGD / 1-bit-Adam family): the residual
    carries each step's quantization error into the next. The int8
    payloads and scales are the reference's exactly (``torch.round`` and
    ``jnp.round`` both round half to even).

  * ``compressed_psum`` — the collective's arithmetic over the members of
    an axis, one tensor each: the members agree on a shared scale (the max
    of their block scales), sum their int8 payloads as int32, and
    dequantize once. Every member receives the returned sum.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import tree as tree_mod

_BLOCK = 256


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """``x`` flattened to fp32, zero-padded to whole blocks: (n_blocks,
    _BLOCK)."""
    flat = x.reshape(-1).to(torch.float32)
    return F.pad(flat, (0, (-flat.shape[0]) % _BLOCK)).reshape(-1, _BLOCK)


def _block_quant(x: torch.Tensor):
    """(int8 payload (n_blocks, _BLOCK), fp32 scale (n_blocks,), n)."""
    blocks = _blocks(x)
    scale = torch.amax(torch.abs(blocks), dim=1) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-20)[:, None])
    return q.to(torch.int8), scale, x.numel()


def _block_dequant(q: torch.Tensor, scale: torch.Tensor, n: int, shape
                   ) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale[:, None]).reshape(-1)[:n]
    return flat.reshape(shape)


def ef_int8_roundtrip(grads, residual=None):
    """(grads, residual) -> (decompressed grads, new residual).

    new_residual = (g + residual) - dequant(quant(g + residual)).
    """
    if residual is None:
        residual = tree_mod.map(
            lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                  device=g.device), grads)

    def one(g, r):
        corrected = g.to(torch.float32) + r
        q, scale, n = _block_quant(corrected)
        deq = _block_dequant(q, scale, n, g.shape)
        return deq, corrected - deq

    out = tree_mod.map(one, grads, residual)
    is_pair = lambda x: isinstance(x, tuple)  # noqa: E731
    return (tree_mod.map(lambda t: t[0], out, is_leaf=is_pair),
            tree_mod.map(lambda t: t[1], out, is_leaf=is_pair))


def compressed_psum(xs) -> torch.Tensor:
    """The int8 all-reduce of ``xs`` (one tensor per member of the axis,
    all of one shape): a shared scale a block (the members' max), int32
    accumulation, one dequantization. Returns the (approximate) sum."""
    scale = torch.stack([_block_quant(x)[1] for x in xs]).amax(dim=0)
    denom = torch.clamp(scale, min=1e-20)[:, None]
    total = sum(torch.round(_blocks(x) / denom).to(torch.int32) for x in xs)
    deq = (total.to(torch.float32) * scale[:, None]).reshape(-1)
    return deq[:xs[0].numel()].reshape(xs[0].shape)
