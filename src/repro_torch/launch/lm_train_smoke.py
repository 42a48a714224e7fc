"""Smoke run of the port's language-model training path on one device.

    PYTHONPATH=src python -m repro_torch.launch.lm_train_smoke

``run`` (chip_smoke's LM-training phase) checks, each with its stated
limit:

a) every registered architecture at its ``smoke_config()``: one
   ``train_loop.make_train_step`` step (AdamW, the global clip, the
   schedule) on ``dev`` and on the CPU from the same weights and batch:
   the loss, every gradient leaf and every updated parameter; qwen3's
   smoke config also with ``grad_accum = 2`` and with ``compress_grads``;
b) mamba2-130m at ``config()``, uncut (bf16 compute on fp32 weights): 5
   steps of B x S = 4 x 2,048, every loss, gradient and parameter finite,
   the first loss within 2 of ln(vocab); the first step's loss and
   gradients at 1 x 256 against the CPU, in bf16 and in fp32; the
   reference's unmasked exponent (``lm_smoke.PLANTS``) planted must make
   the gradients non-finite; its bound from the traced step (the SSD's
   FLOPs counted by ``launch/hlo_analysis.py``) beside the ms a step;
c) qwen3-8b at its published width, its depth cut to 4 layers: the first
   step's gradients with ``attn_remat`` on and off (bitwise), and with
   q_block = k_block = S (one block) against the chunked ones, with the
   planted "no rescale" rejected; 3 steps with each ``attn_remat``
   setting (bitwise); a checkpoint written after step 2 and restored,
   whose step 3 is bitwise the uninterrupted one; the same checkpoint
   restored by ``elastic.resume`` onto the host mesh in ``tp`` and its
   parameters remeshed to the ``fsdp2d`` specs, step 3 again bitwise; ms
   a step, tokens/s and peak memory beside the roofline bound; one step
   timed with the deterministic algorithms off; the dry run's trace of
   the same step on a 1 x 1 mesh (``traced_step``): its bf16 and fp32
   product GFLOP beside ``step_bound_ms``'s, its bound, and its predicted
   peak beside the measured one (on the card the measured peak must lie
   within 0.9-1.5 times the prediction);
d) ``launch/train.py --mode lm`` killed once its step-3 checkpoint is
   written, and rerun: its final checkpoint bitwise an uninterrupted
   run's.

Everything runs under ``utils.deterministic()``. The full configs are for
the card (qwen3-8b's 2.016 B parameters with AdamW take 32.3 GB); the CPU
tests drive b) to d) at the smoke widths. Every line names the device.
"""
from __future__ import annotations

import argparse
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch import configs, tree
from repro_torch.core import perf_model
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import compression, elastic
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.tgn_sharding import TenantMesh
from repro_torch.launch import dryrun
from repro_torch.launch import main_path as mp
from repro_torch.launch import mesh
from repro_torch.launch import train as train_cli
from repro_torch.launch.lm_smoke import (card_line, check, planted, sync,
                                         to_device)
from repro_torch.models import lm_common
from repro_torch.training import optim as opt_mod
from repro_torch.training import train_loop as TL
from repro_torch.training.lr_schedule import ScheduleConfig
from repro_torch.utils import deterministic, resolve_device

#: fp32 losses, card against CPU: sums in other orders
LOSS_RTOL = 1e-5
#: an fp32 gradient leaf, card against CPU: |d| <= GRAD_RTOL |g| +
#: GRAD_ATOL_SCALE max|g| over the whole tree (some leaves hold entries
#: that are rounding noise on both sides); the RG-LRU hybrid's atol is
#: 1e-5 max|g|: its embedding gradient comes back through the
#: recurrence's chain of 32 steps, whose products' rounding it amplifies
#: (1.69 of the 1e-6 limit on an H100, PERF.md)
GRAD_RTOL, GRAD_ATOL_SCALE = 1e-4, 1e-6
ATOL_SCALE_OF = {"recurrentgemma_9b": 1e-5}
#: an updated parameter after AdamW's first step: |d| <= PARAM_RTOL (|p| +
#: lr) plus the move a gradient difference within the gradient limit can
#: cause (``step_param_ratio``)
PARAM_RTOL = 1e-4
#: bf16 compute (mamba2-130m at 1 x 256, card against CPU; qwen3-8b one
#: block against 8 x 4): each leaf's relative L2 error. A 1-ulp difference
#: before a bf16 rounding moves the rounded value by 2^-8, such moves
#: compound through the layers and back, and at random weights a
#: gradient is a sum over tokens that mostly cancels. Sound readings on an
#: H100: 0.0576 (mamba2-130m's in_proj), 0.0129 (qwen3-8b); the planted
#: no-rescale reads 0.529 (PERF.md)
BF16_LOSS_RTOL = 5e-3
BF16_GRAD_REL = 0.1
#: fp32 compute at a published width, card against CPU: each leaf's
#: relative L2 error. Entry by entry the smoke configs' rule does not
#: carry over: mamba2-130m's embedding rows come back through 24 layers
#: of 768-wide sums and read 9.71 of |d| <= 1e-4 |g| + 1e-6 max|g| on an
#: H100, the tree's largest gradient being far larger than theirs
F32_GRAD_REL = 1e-3


def lm_step_config(steps: int, lr: float = mp.LM_TRAIN_LR,
                   **kw) -> TL.TrainConfig:
    """AdamW at ``lr`` with the global clip, a one-step warmup and a
    cosine over ``steps`` (steps are taken from index 1: at 0 the
    schedule's scale is 0)."""
    return TL.TrainConfig(
        optim=opt_mod.OptimConfig(lr=lr),
        sched=ScheduleConfig(warmup_steps=1, total_steps=steps + 1), **kw)


def batch_on(cfg, step: int, B: int, S: int, dev) -> dict:
    """``train.lm_batch`` of ``step`` as tensors on ``dev``."""
    return {k: torch.as_tensor(v).to(dev)
            for k, v in train_cli.lm_batch(cfg, step, B, S).items()}


def loss_and_grads(cfg, params, batch) -> tuple:
    loss, _, grads = TL.value_and_grad(
        lambda p, b: (lm_common.loss_fn(p, cfg, b), None), params, batch)
    return loss, grads


def grad_ratio(got, want, atol_scale: float = GRAD_ATOL_SCALE
               ) -> tuple[float, str]:
    """The largest |d| / (GRAD_RTOL |g| + atol_scale max|g|) over every
    leaf (<= 1 passes), and its leaf's path."""
    want_l = [w.double().cpu() for w in tree.leaves(want)]
    atol = atol_scale * max(float(w.abs().max()) for w in want_l)
    worst, where = 0.0, ""
    for path, g, w in zip(tree.leaf_paths(want), tree.leaves(got), want_l):
        r = float(((g.double().cpu() - w).abs()
                   / (GRAD_RTOL * w.abs() + atol)).max())
        if r > worst:
            worst, where = r, path
    return worst, where


def step_param_ratio(got, want, grads, tcfg) -> tuple[float, str]:
    """The largest |d| / limit over the parameters after AdamW's first
    step (<= 1 passes), and its leaf's path. The first step moves an entry
    by lr (g / (|g| + eps) + wd p), g clipped by c = min(1, clip / ||g||):
    where two gradients differ by at most delta (the gradient limit, plus
    one int8 quantum of the entry's block with ``compress_grads``), the
    moves differ by at most lr min(2, c delta eps / (max(c |g| - c delta,
    0) + eps)^2), and the rest is the update's rounding, PARAM_RTOL (|p|
    + lr): p - lr u rounds relative to its operands, and a parameter the
    step brings near 0 keeps that error. ``grads`` are the CPU's."""
    oc = tcfg.optim
    g_all = [g.double().cpu() for g in tree.leaves(grads)]
    atol = GRAD_ATOL_SCALE * max(float(g.abs().max()) for g in g_all)
    norm = math.sqrt(sum(float(torch.sum(g * g)) for g in g_all))
    c = min(1.0, oc.global_clip / max(norm, 1e-12)) if oc.global_clip > 0 \
        else 1.0
    worst, where = 0.0, ""
    for path, p, w, g in zip(tree.leaf_paths(want), tree.leaves(got),
                             tree.leaves(want), g_all):
        delta = GRAD_RTOL * g.abs() + atol
        if tcfg.compress_grads:
            blocks = compression._blocks(g)
            quantum = (blocks.abs().amax(dim=1, keepdim=True) / 127.0
                       ).expand_as(blocks).reshape(-1)[:g.numel()]
            delta = delta + quantum.reshape(g.shape)
        move = oc.lr * torch.clamp(
            c * delta * oc.eps / (torch.clamp(c * (g.abs() - delta), min=0)
                                  + oc.eps) ** 2, max=2.0)
        w = w.double().cpu()
        ratio = ((p.double().cpu() - w).abs()
                 / (PARAM_RTOL * (w.abs() + oc.lr) + move))
        r = float(ratio.max())
        if r > worst:
            i = int(ratio.argmax())
            worst, where = r, (f"{path}[{i}] (p {float(p.reshape(-1)[i]):.9g}"
                               f" vs {float(w.reshape(-1)[i]):.9g}, g "
                               f"{float(g.reshape(-1)[i]):.4g}, move bound "
                               f"{float(move.reshape(-1)[i]):.3g})")
    return worst, where


def rel_l2(got, want) -> tuple[float, str]:
    """The largest leaf-wise ||got - want|| / ||want||, and its path."""
    worst, where = 0.0, ""
    for path, g, w in zip(tree.leaf_paths(want), tree.leaves(got),
                          tree.leaves(want)):
        g, w = g.double().cpu(), w.double().cpu()
        n = float(torch.linalg.vector_norm(w))
        r = float(torch.linalg.vector_norm(g - w)) / max(n, 1e-30)
        if r > worst:
            worst, where = r, path
    return worst, where


def n_nonfinite(t) -> int:
    """How many leaves of ``t`` hold a NaN or an inf."""
    return sum(not bool(torch.isfinite(x).all()) for x in tree.leaves(t))


def trees_equal(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
               for x, y in zip(tree.leaves(a), tree.leaves(b)))


# ---------------------------------------------------------------------------
# a) the smoke configs, dev against the CPU
# ---------------------------------------------------------------------------


def smoke_step(arch: str, cfg, dev, card: str, label: str = "",
               **train_kw) -> dict:
    """One training step of ``cfg`` on ``dev`` and on the CPU from the same
    weights and batch: loss, gradients, updated parameters."""
    B, S = mp.LM_TRAIN_B, mp.LM_TRAIN_S
    tcfg = lm_step_config(1, **train_kw)
    cpu = torch.device("cpu")
    p_cpu = lm_common.init_params(
        torch.Generator().manual_seed(mp.LM_TRAIN_SEED), cfg, cpu)
    runs = []
    for d, params in ((cpu, p_cpu), (dev, to_device(p_cpu, dev))):
        batch = batch_on(cfg, 0, B, S, d)
        loss, grads = loss_and_grads(cfg, params, batch)
        step = TL.make_train_step(
            lambda p, b: lm_common.loss_fn(p, cfg, b), tcfg)
        new_p, _, metrics = step(params, TL.init_train_state(tcfg, params),
                                 batch, 1)
        runs.append((loss, grads, new_p, metrics))
    (l_c, g_c, p_c, m_c), (l_d, g_d, p_d, m_d) = runs
    loss_err = abs(float(l_d) - float(l_c)) / abs(float(l_c))
    step_err = abs(float(m_d["loss"]) - float(m_c["loss"])) / abs(
        float(m_c["loss"]))
    atol_scale = ATOL_SCALE_OF.get(arch, GRAD_ATOL_SCALE)
    g_r, g_at = grad_ratio(g_d, g_c, atol_scale)
    p_r, p_at = step_param_ratio(p_d, p_c, g_c, tcfg)
    name = arch + (f" {label}" if label else "")
    quantum = ", one int8 quantum added" if tcfg.compress_grads else ""
    print(f"lm train smoke {name}: loss {float(l_c):.6f}, {dev} vs cpu "
          f"rel {loss_err:.3g} (step's {step_err:.3g}; rtol {LOSS_RTOL}); "
          f"gradients {g_r:.3g} of the limit at {g_at} (|d| <= "
          f"{GRAD_RTOL} |g| + {atol_scale} max|g|); updated "
          f"parameters {p_r:.3g} of the limit at {p_at} (|d| <= "
          f"{PARAM_RTOL} (|p| + lr) + the first step's move under that "
          f"gradient limit{quantum}); on {card}", flush=True)
    check(loss_err <= LOSS_RTOL and step_err <= LOSS_RTOL, f"{name}: loss")
    check(g_r <= 1.0, f"{name}: gradients")
    check(p_r <= 1.0, f"{name}: updated parameters")
    check(n_nonfinite(g_d) == 0, f"{name}: finite gradients")
    return {"loss": loss_err, "grads": g_r, "params": p_r}


def smoke_all(dev, card: str) -> dict:
    out = {arch: smoke_step(arch, configs.get(arch).smoke_config(), dev,
                            card) for arch in configs.all_archs()}
    qwen = configs.get("qwen3_8b").smoke_config()
    out["qwen3_8b grad_accum=2"] = smoke_step(
        "qwen3_8b", qwen, dev, card, "grad_accum=2", grad_accum=2)
    out["qwen3_8b compress_grads"] = smoke_step(
        "qwen3_8b", qwen, dev, card, "compress_grads", compress_grads=True)
    return out


#: the measured peak of a step over the dry run's prediction
#: (``traced_step``): the allocator's block rounding and cuBLAS's
#: workspaces come on top of the live storages the trace follows
PEAK_RATIO = (0.9, 1.5)


def traced_step(cfg, B: int, S: int, dev) -> dict:
    """The dry run's record (``launch/dryrun.run_cell``) of one training
    step of ``cfg`` at B x S on a 1 x 1 mesh of ``dev``'s type: the
    products' FLOPs by dtype, the roofline bound on ``H100_SXM`` and the
    predicted peak memory, from the traced ops (``meta`` tensors, nothing
    allocated)."""
    one = TenantMesh(np.asarray([[torch.device("meta")]], dtype=object),
                     ("data", "model"))
    try:
        return dryrun.run_cell(cfg.arch.removesuffix("_smoke"), "train_4k",
                               override_cfg=cfg, mesh=one,
                               seq_len=S, global_batch=B, device=dev.type)
    finally:
        dryrun.destroy_world()


def traced_bound_ms(rec: dict) -> float:
    rl = rec["roofline"]
    return max(rl["compute_s"], rl["memory_s"], rl["collective_s"]) * 1e3


# ---------------------------------------------------------------------------
# b) mamba2-130m at its published config
# ---------------------------------------------------------------------------


def train_mamba(cfg, dev, card: str, spec: dict = mp.LM_TRAIN_MAMBA
                ) -> dict:
    """``spec["steps"]`` steps of ``cfg`` from seeded weights on ``dev``,
    every value finite; the first batch's gradients against the CPU at the
    smaller shape; the planted unmasked exponent must be caught."""
    B, S, n = spec["batch"], spec["seq"], spec["steps"]
    params = lm_common.init_params(
        torch.Generator(device=dev).manual_seed(mp.LM_TRAIN_SEED), cfg, dev)
    first = batch_on(cfg, 0, B, S, dev)
    loss0, g0 = loss_and_grads(cfg, params, first)
    bad0 = n_nonfinite(g0)
    del g0
    with planted("unmasked exponent"):
        _, gp = loss_and_grads(cfg, params, first)
    bad_planted = n_nonfinite(gp)
    del gp

    # the first batch's first rows against the CPU: in the config's
    # dtype, and in fp32
    small = batch_on(cfg, 0, spec["cpu_batch"], spec["cpu_seq"], dev)
    p_cpu = to_device(params, "cpu")
    cpu = {}
    for c in (cfg, cfg.replace(dtype="float32")):
        l_d, g_d = loss_and_grads(c, params, small)
        l_c, g_c = loss_and_grads(c, p_cpu, to_device(small, "cpu"))
        cpu[c.dtype] = (abs(float(l_d) - float(l_c)) / abs(float(l_c)),
                        *rel_l2(g_d, g_c))
        del g_d, g_c
    del p_cpu
    cpu_loss, cpu_grad, cpu_at = cpu[cfg.dtype]
    f32_loss, f32_grad, f32_at = cpu["float32"]

    tcfg = lm_step_config(n)
    step = TL.make_train_step(lambda p, b: lm_common.loss_fn(p, cfg, b),
                              tcfg)
    opt = TL.init_train_state(tcfg, params)
    losses, ms = [], []
    finite = True
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for i in range(n):
        batch = first if i == 0 else batch_on(cfg, i, B, S, dev)
        sync(dev)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch, i + 1)
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        finite &= (math.isfinite(losses[-1])
                   and math.isfinite(float(m["grad_norm"]))
                   and n_nonfinite(params) == 0)
    peak = (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else float("nan"))
    ln_v = math.log(cfg.vocab)
    med = statistics.median(ms[1:] or ms)
    print(f"lm train {cfg.arch}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}, chunk {cfg.chunk}, "
          f"{cfg.dtype}; {n} steps of B x S = {B} x {S}: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)} (ln vocab "
          f"{ln_v:.4f}), every loss, gradient and parameter finite: "
          f"{finite} ({bad0} non-finite gradient leaves at the first "
          f"batch; with the unmasked exponent planted {bad_planted}, "
          f"{'rejected' if bad_planted else 'NOT rejected'}); ms a step "
          f"{', '.join(f'{x:.1f}' for x in ms)} (median of steps 2-{n} "
          f"{med:.1f}, {B * S / med * 1e3:.0f} tokens/s); peak memory "
          f"{peak:.2f} GiB; against the CPU at "
          f"{spec['cpu_batch']} x {spec['cpu_seq']}: {cfg.dtype} loss rel "
          f"{cpu_loss:.3g} (rtol {BF16_LOSS_RTOL}), gradients rel L2 "
          f"{cpu_grad:.3g} at {cpu_at} (limit {BF16_GRAD_REL} a leaf); "
          f"float32 loss rel {f32_loss:.3g} (rtol {LOSS_RTOL}), gradients "
          f"rel L2 {f32_grad:.3g} at {f32_at} (limit {F32_GRAD_REL} a "
          f"leaf); on {card}", flush=True)
    check(finite and bad0 == 0, f"{cfg.arch}: finite losses and gradients")
    check(abs(float(loss0) - ln_v) < 2.0, f"{cfg.arch}: first loss within "
          "2 of ln(vocab)")
    check(bad_planted > 0, f"{cfg.arch}: the planted unmasked exponent "
          "makes the gradients non-finite")
    check(cpu_loss <= BF16_LOSS_RTOL, f"{cfg.arch}: loss against the CPU")
    check(cpu_grad <= BF16_GRAD_REL, f"{cfg.arch}: gradients against the "
          "CPU")
    check(f32_loss <= LOSS_RTOL and f32_grad <= F32_GRAD_REL,
          f"{cfg.arch}: float32 loss and gradients against the CPU")
    del params, opt
    t0 = time.perf_counter()
    rec = traced_step(cfg, B, S, dev)
    fl = rec["per_device"]["flops_by_dtype"]
    traced_ms = traced_bound_ms(rec)
    print(f"lm train {cfg.arch} traced step ({B} x {S}, "
          f"launch/dryrun.py on a 1 x 1 mesh, {time.perf_counter() - t0:.1f}"
          f" s): products {fl.get('bf16', 0.0) / 1e9:.1f} GFLOP bf16 and "
          f"{fl.get('f32', 0.0) / 1e9:.1f} GFLOP fp32 (the SSD's einsums "
          f"among them), {rec['per_device']['flops'] / 1e9:.1f} GFLOP in "
          f"all, {rec['per_device']['bytes'] / 1e9:.1f} GB moved; bound "
          f"{traced_ms:.1f} ms ({rec['roofline']['bound']}) against "
          f"{med:.1f} ms measured a step; predicted peak "
          f"{rec['memory']['peak_bytes'] / 2**30:.2f} GiB against "
          f"{peak:.2f} GiB measured; folds {rec['folds']}; on {card}",
          flush=True)
    check(rec["status"] == "ok", f"{cfg.arch}: the traced step")
    return {"losses": losses, "ms": ms, "peak_gib": peak,
            "traced_bound_ms": traced_ms,
            "cpu_loss": cpu_loss, "cpu_grad": cpu_grad, "f32_loss": f32_loss,
            "f32_grad": f32_grad,
            "planted_nonfinite": bad_planted}


# ---------------------------------------------------------------------------
# c) qwen3-8b at its published width
# ---------------------------------------------------------------------------


def step_bound_ms(cfg, B: int, S: int, attn_remat: bool) -> tuple:
    """The roofline bound of one training step on ``H100_SXM``: the bf16
    products (6 N T, plus the forward the checkpoints recompute: every
    block and the loss chunks' head), the attention's fp32 einsums on the
    CUDA cores (forward, recompute and twice in the backward, once more
    with ``attn_remat``; 4 S^2 h d_head each a layer, no causal skip), and
    AdamW's 28 bytes a parameter. Returns (ms, GFLOP bf16, GFLOP fp32,
    GB)."""
    T = B * S
    emb = cfg.vocab * cfg.d_model
    blocks = cfg.n_params - 2 * emb - cfg.d_model
    bf16 = 6.0 * (cfg.n_params - emb) * T + 2.0 * (blocks + emb) * T
    passes = 5 if attn_remat else 4
    fp32 = passes * 4.0 * B * S * S * cfg.n_heads * cfg.d_head * cfg.n_layers
    nbytes = 28.0 * cfg.n_params
    r16 = perf_model.roofline(bf16, nbytes, precision="bf16")
    r32 = perf_model.roofline(fp32, 0.0, precision="fp32")
    ms = max(r16.compute_s + r32.compute_s, r16.memory_s) * 1e3
    return ms, bf16 / 1e9, fp32 / 1e9, nbytes / 1e9


def train_qwen(cfg, dev, card: str, spec: dict = mp.LM_TRAIN_QWEN) -> dict:
    """``cfg`` (remat "nothing") from seeded weights on ``dev``: the first
    batch's gradients four ways, then ``spec["steps"]`` steps with each
    ``attn_remat`` setting and a resumed last step."""
    B, S, n, at = spec["batch"], spec["seq"], spec["steps"], spec[
        "ckpt_after"]
    cfg = cfg.replace(remat="nothing", attn_remat=False)

    def fresh():
        return lm_common.init_params(
            torch.Generator(device=dev).manual_seed(mp.LM_TRAIN_SEED), cfg,
            dev)

    batches = [batch_on(cfg, i, B, S, dev) for i in range(n)]
    params = fresh()
    sync(dev)
    print(f"lm train {cfg.arch}: {cfg.n_layers} layers (cut from the "
          f"published depth), d_model {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.d_head}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, {cfg.dtype}: {cfg.n_params / 1e9:.3f} B parameters;"
          f" B x S = {B} x {S}, {-(-S // cfg.q_block)} x "
          f"{-(-S // cfg.k_block)} query x key blocks, "
          f"{S // min(cfg.loss_chunk, S)} loss chunks; on {card}",
          flush=True)

    # the first batch's gradients four ways
    l_a, g_a = loss_and_grads(cfg, params, batches[0])
    l_b, g_b = loss_and_grads(cfg.replace(attn_remat=True), params,
                              batches[0])
    remat_equal = bool(torch.equal(l_a, l_b)) and trees_equal(g_a, g_b)
    del g_b
    one = cfg.replace(q_block=S, k_block=S)
    l_1, g_1 = loss_and_grads(one, params, batches[0])
    one_err, one_at = rel_l2(g_1, g_a)
    one_loss = abs(float(l_1) - float(l_a)) / abs(float(l_a))
    del g_1
    with planted("no rescale"):
        l_p, g_p = loss_and_grads(cfg, params, batches[0])
    bad_err, bad_at = rel_l2(g_p, g_a)
    del g_p, g_a
    rejected = bad_err > BF16_GRAD_REL
    print(f"lm train {cfg.arch} gradients of the first batch: attn_remat "
          f"on vs off bitwise {remat_equal}; one block (q_block = k_block "
          f"= {S}) vs chunked: loss rel {one_loss:.3g}, gradients rel L2 "
          f"{one_err:.3g} at {one_at}; with the no rescale planted "
          f"{bad_err:.3g} at {bad_at} ("
          f"{'rejected' if rejected else 'NOT rejected'}) (limit "
          f"{BF16_GRAD_REL} a leaf); on {card}", flush=True)
    check(remat_equal, f"{cfg.arch}: attn_remat on and off, bitwise")
    check(one_err <= BF16_GRAD_REL and one_loss <= BF16_LOSS_RTOL,
          f"{cfg.arch}: one block against the chunked gradients")
    check(rejected, f"{cfg.arch}: the limit rejects the planted no rescale")
    del params

    tcfg = lm_step_config(n, lr=3e-4)
    root = tempfile.mkdtemp(prefix="lm-train-ckpt-")
    runs = {}
    try:
        for attn_remat in (False, True):
            c = cfg.replace(attn_remat=attn_remat)
            step = TL.make_train_step(
                lambda p, b, c=c: lm_common.loss_fn(p, c, b), tcfg)
            params = fresh()
            opt = TL.init_train_state(tcfg, params)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            losses, ms = [], []
            for i in range(n):
                if i == at and not attn_remat:
                    t0 = time.perf_counter()
                    ckpt.save(root, at, {"params": params, "opt": opt})
                    ckpt_s = time.perf_counter() - t0
                sync(dev)
                t0 = time.perf_counter()
                params, opt, m = step(params, opt, batches[i], i + 1)
                sync(dev)
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(m["loss"]))
            peak = (torch.cuda.max_memory_allocated(dev) / 2**30
                    if dev.type == "cuda" else float("nan"))
            runs[attn_remat] = dict(losses=losses, ms=ms, peak_gib=peak,
                                    params=to_device(params, "cpu"))
            if attn_remat:
                # a step with the deterministic algorithms off, timed
                # against one with them on, from the same state
                times = {}
                for det in (False, True):
                    torch.use_deterministic_algorithms(det)
                    sync(dev)
                    t0 = time.perf_counter()
                    step(params, opt, batches[-1], n + 1)
                    sync(dev)
                    times[det] = (time.perf_counter() - t0) * 1e3
                runs["det_ms"] = times
            del params, opt

        # resume: the checkpoint after step ``at``, then the steps after it
        like = {"params": lm_common.abstract_params(cfg)}
        like["opt"] = TL.init_train_state(tcfg, like["params"])
        t0 = time.perf_counter()
        state, _ = ckpt.restore(root, like, step=at, device=dev)
        restore_s = time.perf_counter() - t0
        gb = sum(x.numel() * x.element_size()
                 for x in tree.leaves(state)) / 1e9
        params, opt = state["params"], state["opt"]
        del state
        step = TL.make_train_step(
            lambda p, b: lm_common.loss_fn(p, cfg, b), tcfg)
        resumed = []
        for i in range(at, n):
            params, opt, m = step(params, opt, batches[i], i + 1)
            resumed.append(float(m["loss"]))
        resume_equal = (resumed == runs[False]["losses"][at:]
                        and trees_equal(params, runs[False]["params"]))
        del params, opt

        # elastic: the same checkpoint onto the host mesh in tp, the live
        # parameters remeshed (through the host, a leaf at a time) to the
        # fsdp2d specs, then the steps after it
        host = mesh.make_host_mesh(dev)
        t0 = time.perf_counter()
        state, _ = elastic.resume(root, like, host, "tp", step=at)
        elastic_s = time.perf_counter() - t0
        opt = state.pop("opt")
        t0 = time.perf_counter()
        params = elastic.remesh(state.pop("params"), host, shd.param_specs(
            like["params"], "fsdp2d", host.shape["model"]))
        sync(dev)
        remesh_s = time.perf_counter() - t0
        elastic_losses = []
        for i in range(at, n):
            params, opt, m = step(params, opt, batches[i], i + 1)
            elastic_losses.append(float(m["loss"]))
        elastic_equal = (elastic_losses == runs[False]["losses"][at:]
                         and trees_equal(params, runs[False]["params"]))
        del params, opt
    finally:
        shutil.rmtree(root, ignore_errors=True)

    a, b = runs[False], runs[True]
    steps_equal = (a["losses"] == b["losses"]
                   and trees_equal(a["params"], b["params"]))
    out = {"remat_equal": remat_equal, "one_block_err": one_err,
           "planted_err": bad_err, "steps_equal": steps_equal,
           "resume_equal": resume_equal, "elastic_equal": elastic_equal,
           "elastic_s": elastic_s, "remesh_s": remesh_s,
           "det_ms": runs["det_ms"]}
    for key, r in ((False, a), (True, b)):
        med = statistics.median(r["ms"][1:] or r["ms"])
        bound, g16, g32, gbytes = step_bound_ms(cfg, B, S, key)
        print(f"lm train {cfg.arch} attn_remat={key}: {n} steps, losses "
              f"{', '.join(f'{x:.4f}' for x in r['losses'])}; ms a step "
              f"{', '.join(f'{x:.1f}' for x in r['ms'])} (median of steps "
              f"2-{n} "
              f"{med:.1f}, {B * S / med * 1e3:.0f} tokens/s); bound "
              f"{bound:.1f} ms ({g16:.0f} GFLOP bf16, {g32:.0f} GFLOP fp32 "
              f"attention, {gbytes:.1f} GB of AdamW traffic on "
              f"{perf_model.H100_SXM.name}); peak memory "
              f"{r['peak_gib']:.2f} GiB; on {card}", flush=True)
        out[f"ms_remat{int(key)}"] = med
        out[f"bound_ms_remat{int(key)}"] = bound
        out[f"peak_gib_remat{int(key)}"] = r["peak_gib"]
    t0 = time.perf_counter()
    rec = traced_step(cfg, B, S, dev)
    fl = rec["per_device"]["flops_by_dtype"]
    bound, g16, g32, _ = step_bound_ms(cfg, B, S, False)
    pred = rec["memory"]["peak_bytes"] / 2**30
    ratio = a["peak_gib"] / pred
    print(f"lm train {cfg.arch} traced step (attn_remat off, {B} x {S}, "
          f"launch/dryrun.py on a 1 x 1 mesh, {time.perf_counter() - t0:.1f}"
          f" s): products {fl.get('bf16', 0.0) / 1e9:.1f} GFLOP bf16 "
          f"(step_bound_ms {g16:.1f}) and {fl.get('f32', 0.0) / 1e9:.1f} "
          f"GFLOP fp32 (step_bound_ms {g32:.1f}), "
          f"{rec['per_device']['flops'] / 1e9:.1f} GFLOP in all, "
          f"{rec['per_device']['bytes'] / 1e9:.1f} GB moved; bound "
          f"{traced_bound_ms(rec):.1f} ms ({rec['roofline']['bound']}; "
          f"step_bound_ms {bound:.1f} ms) against "
          f"{out['ms_remat0']:.1f} ms measured; predicted peak {pred:.2f} GiB"
          f", measured {a['peak_gib']:.2f} GiB (ratio {ratio:.3f}, limit "
          f"{PEAK_RATIO[0]}-{PEAK_RATIO[1]}); folds {rec['folds']}; on "
          f"{card}", flush=True)
    check(rec["status"] == "ok", f"{cfg.arch}: the traced step")
    if dev.type == "cuda":
        check(PEAK_RATIO[0] <= ratio <= PEAK_RATIO[1],
              f"{cfg.arch}: measured peak within {PEAK_RATIO} of the "
              "traced prediction")
    out["traced_bound_ms"] = traced_bound_ms(rec)
    out["predicted_peak_gib"] = pred
    print(f"lm train {cfg.arch}: the {n} steps with attn_remat on and off "
          f"bitwise {steps_equal}; checkpoint after step {at} ({gb:.1f} GB: "
          f"saved in {ckpt_s:.1f} s, restored in {restore_s:.1f} s), its "
          f"steps {at + 1}..{n} bitwise the uninterrupted ones "
          f"{resume_equal}; elastic.resume onto the host mesh in tp "
          f"({elastic_s:.1f} s) and its parameters remeshed to the fsdp2d "
          f"specs ({remesh_s:.1f} s), steps {at + 1}..{n} bitwise "
          f"{elastic_equal}; a step with deterministic algorithms off "
          f"{runs['det_ms'][False]:.1f} ms, on {runs['det_ms'][True]:.1f} "
          f"ms; on {card}", flush=True)
    check(steps_equal, f"{cfg.arch}: attn_remat on and off, 3 steps bitwise")
    check(resume_equal, f"{cfg.arch}: the resumed steps bitwise")
    check(elastic_equal, f"{cfg.arch}: the steps after elastic.resume and "
          "remesh bitwise")
    return out


# ---------------------------------------------------------------------------
# d) --mode lm killed and resumed
# ---------------------------------------------------------------------------


def cli_resume(dev, card: str, spec: dict = mp.LM_TRAIN_CLI) -> dict:
    """``launch.train --mode lm`` run through, and run again killed once its
    step-3 checkpoint is committed, then rerun: the final checkpoints
    (parameters and optimizer state) must be equal bit for bit."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    n, every = spec["steps"], spec["ckpt_every"]
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--mode", "lm",
           "--arch", spec["arch"], "--steps", str(n), "--batch",
           str(spec["batch"]), "--seq", str(spec["seq"]), "--ckpt-every",
           str(every), "--log-every", "1"]
    if dev.type != "cuda":
        cmd += ["--device", dev.type]
    root = tempfile.mkdtemp(prefix="lm-train-cli-")
    whole, killed = os.path.join(root, "whole"), os.path.join(root, "killed")
    try:
        t0 = time.perf_counter()
        subprocess.run(cmd + ["--ckpt", whole], env=env, check=True,
                       capture_output=True, text=True, timeout=900)
        whole_s = time.perf_counter() - t0
        proc = subprocess.Popen(cmd + ["--ckpt", killed], env=env,
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        try:
            while proc.poll() is None and every not in ckpt.list_steps(
                    killed):
                time.sleep(0.002)
        finally:
            proc.kill()
            proc.wait()
        at = ckpt.latest_step(killed)
        check(at == every, f"--mode lm killed after its step-{every} "
              f"checkpoint and before the next (latest step {at})")
        rerun = subprocess.run(cmd + ["--ckpt", killed], env=env,
                               check=True, capture_output=True, text=True,
                               timeout=900).stdout
        resumed = f"[lm] resumed from step {every}" in rerun
        cfg = train_cli.lm_config(argparse.Namespace(preset=None,
                                                     arch=spec["arch"]))
        like = {"params": lm_common.abstract_params(cfg)}
        like["opt"] = TL.init_train_state(
            TL.TrainConfig(), like["params"])
        want, _ = ckpt.restore(whole, like, step=n, device="cpu")
        got, _ = ckpt.restore(killed, like, step=n, device="cpu")
        equal = trees_equal(got, want)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"lm train cli: --mode lm --arch {spec['arch']} --steps {n} "
          f"--batch {spec['batch']} --seq {spec['seq']} on {dev.type}, "
          f"killed after its step-{every} checkpoint and rerun: resumed "
          f"from step {every} {resumed}, final parameters and optimizer "
          f"state bitwise the uninterrupted run's {equal} (that run "
          f"{whole_s:.1f} s); on {card}", flush=True)
    check(resumed, "--mode lm resumed from its checkpoint")
    check(equal, "--mode lm killed and resumed == uninterrupted")
    return {"resumed": resumed, "equal": equal}


def run(dev: torch.device, card: str) -> dict:
    """The whole LM-training phase; raises on a failed check."""
    t0 = time.perf_counter()
    with deterministic():
        out = {"smoke": smoke_all(dev, card)}
        out["mamba"] = train_mamba(
            configs.get(mp.LM_TRAIN_MAMBA["arch"]).config(), dev, card)
        qwen = configs.get(mp.LM_TRAIN_QWEN["arch"]).config()
        out["qwen"] = train_qwen(
            qwen.replace(n_layers=mp.LM_TRAIN_QWEN["n_layers"]), dev, card)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out["cli"] = cli_resume(dev, card)
    print(f"lm train phase: {time.perf_counter() - t0:.1f} s on {card}",
          flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = run(dev, card_line(dev))
    print("lm-train-smoke: OK")
    return out


if __name__ == "__main__":
    main()
