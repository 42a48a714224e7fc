"""Optimizers written out: AdamW, Lion and SGD with momentum.

Port of ``repro.training.optim``, with its arithmetic:

  * the global-norm clip scales by ``min(1, max_norm / max(norm, 1e-12))``
    (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm instead);
  * weight decay applies only to leaves with ``ndim >= 2``
    (``torch.optim.AdamW`` decays every parameter);
  * moments are stored in fp32, bf16, or int8 block-quantized with one
    fp32 scale per 256 elements (8-bit-Adam style).

The optimizer state is a tree congruent to the parameters, ``{"step",
"m"[, "v"]}``, in the reference's layout, so it checkpoints and converts
across packages (``distributed/checkpoint.py``, ``convert.py``). The
update is a pure function ``(state, grads, params) -> (state, params)``:
it builds new tensors and changes none it is given.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
import torch.nn.functional as tnf

from repro_torch import tree as tree_mod
from repro_torch.utils import FrozenConfig

Tree = Any
_QBLOCK = 256  # int8 quantization block (elements)


@dataclasses.dataclass(frozen=True)
class OptimConfig(FrozenConfig):
    name: str = "adamw"          # adamw | lion | sgd
    lr: float = 3e-4             # base lr (scaled by the schedule)
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    momentum: float = 0.9        # sgd
    moment_dtype: str = "float32"   # float32 | bfloat16 | int8
    global_clip: float = 1.0     # 0 disables


# ---------------------------------------------------------------------------
# int8 block quantization for moments
# ---------------------------------------------------------------------------


class QTensor(NamedTuple):
    q: torch.Tensor        # int8, padded flat (n_blocks * _QBLOCK,)
    scale: torch.Tensor    # fp32 (n_blocks,)


def _is_moment(x) -> bool:
    return isinstance(x, QTensor)


def _quantize(x: torch.Tensor) -> QTensor:
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.shape[0]) % _QBLOCK
    flat = tnf.pad(flat, (0, pad)).reshape(-1, _QBLOCK)
    scale = flat.abs().amax(dim=1) / 127.0
    q = torch.round(flat / scale.clamp(min=1e-20)[:, None])
    return QTensor(q.to(torch.int8).reshape(-1), scale)


def _dequantize(qt: QTensor, shape) -> torch.Tensor:
    flat = qt.q.to(torch.float32).reshape(-1, _QBLOCK) * qt.scale[:, None]
    n = 1
    for s in shape:
        n *= s
    return flat.reshape(-1)[:n].reshape(shape)


def _store_moment(x: torch.Tensor, dtype: str):
    if dtype == "int8":
        return _quantize(x)
    return x.to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)


def _load_moment(m, shape) -> torch.Tensor:
    if isinstance(m, QTensor):
        return _dequantize(m, shape)
    return m.to(torch.float32)


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_mod.leaves(tree)))


def clip_scale(grads: Tree, max_norm: float):
    """``(scale, global norm)``: the clip multiplies every gradient by
    ``min(1, max_norm / max(norm, 1e-12))``."""
    gn = global_norm(grads)
    return torch.clamp(max_norm / gn.clamp(min=1e-12), max=1.0), gn


def clip_by_global_norm(grads: Tree, max_norm: float):
    """``(clipped grads, global norm)``."""
    scale, gn = clip_scale(grads, max_norm)
    return tree_mod.map(lambda g: g.to(torch.float32) * scale, grads), gn


def _is_decay_param(p: torch.Tensor) -> bool:
    """No weight decay on biases and other 1-d leaves."""
    return p.ndim >= 2


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


def init_state(cfg: OptimConfig, params: Tree) -> dict:
    def zeros(p):
        return _store_moment(torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), cfg.moment_dtype)

    first = tree_mod.leaves(params)[0]
    state = {"step": torch.zeros((), dtype=torch.int32, device=first.device),
             "m": tree_mod.map(zeros, params)}
    if cfg.name == "adamw":
        state["v"] = tree_mod.map(zeros, params)
    return state


def _split(out, n: int) -> list:
    """A tree of n-tuples -> n trees."""
    return [tree_mod.map(lambda t, i=i: t[i], out, is_leaf=lambda x:
                         isinstance(x, tuple) and not _is_moment(x))
            for i in range(n)]


def apply_updates(cfg: OptimConfig, state: dict, grads: Tree, params: Tree,
                  lr_scale=1.0):
    """One optimizer step. Returns ``(new_state, new_params)``.

    The clip's scale is applied leaf by leaf as each leaf is updated (the
    values ``clip_by_global_norm`` gives, without a second gradient tree),
    and AdamW's arithmetic runs in place on the fresh tensors it makes, in
    the reference's order of operations, so one leaf's temporaries stay
    few: at full width the old and new trees already fill most of the
    card."""
    scale = None
    if cfg.global_clip > 0:
        scale, _ = clip_scale(grads, cfg.global_clip)

    def grad32(g):
        gf = g.to(torch.float32)
        return gf if scale is None else gf * scale

    step = state["step"] + 1
    lr = cfg.lr * lr_scale

    if cfg.name == "adamw":
        bc1 = 1.0 - cfg.b1 ** step.to(torch.float32)
        bc2 = 1.0 - cfg.b2 ** step.to(torch.float32)

        def upd(g, p, m, v):
            gf = grad32(g)
            pf = p.to(torch.float32)
            mf = _load_moment(m, p.shape) * cfg.b1     # m b1 + (1-b1) g
            t = (1 - cfg.b1) * gf
            mf += t
            vf = _load_moment(v, p.shape) * cfg.b2     # v b2 + (1-b2) g g
            t = (1 - cfg.b2) * gf
            t *= gf
            vf += t
            del gf
            delta = mf / bc1                            # mh / (sqrt(vh)+eps)
            t = vf / bc2
            t.sqrt_()
            t += cfg.eps
            delta /= t
            del t
            if _is_decay_param(p):
                delta += cfg.weight_decay * pf
            delta *= lr
            return ((pf - delta).to(p.dtype),
                    _store_moment(mf, cfg.moment_dtype),
                    _store_moment(vf, cfg.moment_dtype))

        out = tree_mod.map(upd, grads, params, state["m"], state["v"],
                           is_leaf=_is_moment)
        new_p, new_m, new_v = _split(out, 3)
        return {"step": step, "m": new_m, "v": new_v}, new_p

    if cfg.name == "lion":
        def upd(g, p, m):
            gf = grad32(g)
            pf = p.to(torch.float32)
            mf = _load_moment(m, p.shape)
            direction = torch.sign(cfg.b1 * mf + (1 - cfg.b1) * gf)
            if _is_decay_param(p):
                direction = direction + cfg.weight_decay * pf
            m_new = cfg.b2 * mf + (1 - cfg.b2) * gf
            return ((pf - lr * direction).to(p.dtype),
                    _store_moment(m_new, cfg.moment_dtype))

        out = tree_mod.map(upd, grads, params, state["m"], is_leaf=_is_moment)
        new_p, new_m = _split(out, 2)
        return {"step": step, "m": new_m}, new_p

    if cfg.name == "sgd":
        def upd(g, p, m):
            gf = grad32(g)
            mf = _load_moment(m, p.shape) * cfg.momentum + gf
            return ((p.to(torch.float32) - lr * mf).to(p.dtype),
                    _store_moment(mf, cfg.moment_dtype))

        out = tree_mod.map(upd, grads, params, state["m"], is_leaf=_is_moment)
        new_p, new_m = _split(out, 2)
        return {"step": step, "m": new_m}, new_p

    raise ValueError(cfg.name)
