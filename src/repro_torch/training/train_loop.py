"""Step-function factory: loss -> grad -> (optional compression) ->
optimizer, the port of ``repro.training.train_loop``.

``make_train_step`` builds

    (params, opt_state, batch, step) -> (params, opt_state, metrics)

Features, as in the reference:
  * micro-batch gradient accumulation: the leading batch axis is split
    into ``grad_accum`` micro-batches, whose losses and gradients are
    summed in fp32 in order from zero and then divided;
  * optional error-feedback int8 gradient compression
    (``distributed/compression.py``), the EF residual riding in
    ``opt_state["ef_residual"]``;
  * a pure step: it returns new trees and changes none it is given.

Gradients come from ``value_and_grad``, which the TGN trainer shares: a
leaf the loss does not reach gets a zero gradient, as under
``jax.value_and_grad``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import tree
from repro_torch.distributed import compression
from repro_torch.training import optim as opt_mod
from repro_torch.training.lr_schedule import ScheduleConfig, schedule
from repro_torch.utils import FrozenConfig


@dataclasses.dataclass(frozen=True)
class TrainConfig(FrozenConfig):
    optim: opt_mod.OptimConfig = opt_mod.OptimConfig()
    sched: ScheduleConfig = ScheduleConfig()
    grad_accum: int = 1            # micro-batches per step
    compress_grads: bool = False   # int8 + error-feedback compression


def value_and_grad(loss_fn, params: dict, *args):
    """``(loss, aux, grads)`` of ``loss_fn(params, *args) -> (loss, aux)``
    with respect to every leaf of ``params``. A leaf the loss does not
    reach (the TGN's LUT boundaries) gets a zero gradient, as under
    ``jax.value_and_grad``; ``aux`` is returned as the loss function gave
    it, still attached to the freed graph (detach what is kept)."""
    live = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    loss, aux = loss_fn(tree.unflatten(params, live), *args)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)]
    return loss.detach(), aux, tree.unflatten(params, grads)


def make_train_step(loss_fn: Callable, tcfg: TrainConfig):
    """loss_fn(params, batch) -> scalar. Returns step(params, opt_state,
    batch, step_idx) -> (params, opt_state, metrics)."""

    def grads_of(params, batch):
        loss, _, grads = value_and_grad(
            lambda p, b: (loss_fn(p, b), None), params, batch)
        return loss, grads

    def step(params, opt_state, batch, step_idx):
        n = tcfg.grad_accum
        if n > 1:
            for x in batch.values():
                assert x.shape[0] % n == 0, (x.shape[0], n)
            dev = tree.leaves(params)[0].device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = tree.map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for j in range(n):
                micro = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[j]
                         for k, v in batch.items()}
                loss_j, g = grads_of(params, micro)
                loss = loss + loss_j
                grads = tree.map(torch.add, grads, g)
            loss = loss / n
            grads = tree.map(lambda g: g / n, grads)
        else:
            loss, grads = grads_of(params, batch)

        if tcfg.compress_grads:
            grads, residual = compression.ef_int8_roundtrip(
                grads, opt_state.get("ef_residual"))
            opt_state = dict(opt_state, ef_residual=residual)

        lr_scale = schedule(tcfg.sched, step_idx)
        inner = {k: v for k, v in opt_state.items() if k != "ef_residual"}
        inner, params = opt_mod.apply_updates(tcfg.optim, inner, grads,
                                              params, lr_scale)
        if "ef_residual" in opt_state:
            inner["ef_residual"] = opt_state["ef_residual"]
        metrics = {"loss": loss, "lr_scale": lr_scale,
                   "grad_norm": opt_mod.global_norm(grads)}
        return params, inner, metrics

    return step


def init_train_state(tcfg: TrainConfig, params) -> dict:
    state = opt_mod.init_state(tcfg.optim, params)
    if tcfg.compress_grads:
        state["ef_residual"] = tree.map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
    return state
