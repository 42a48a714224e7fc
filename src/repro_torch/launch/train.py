"""Training entry point, the port of ``repro.launch.train``.

``--mode tgn`` (the default): the paper's workflow on a synthetic
temporal-graph stream. Train the TGN-attn teacher, then distill the
SAT+LUT+NP students (Eq. 17), printing AP on the test window for the
teacher and every Table-II student (``+SAT``, ``+LUT``, ``+NP(L)``,
``+NP(M)``, ``+NP(S)``). With ``--ckpt`` each trained model is saved.

``--mode lm``: language-model training of ``--arch``'s smoke config (or
``--preset 100m``, a 12-layer fp32 transformer) on step-seeded synthetic
batches, AdamW under the warmup-cosine schedule, ``--grad-accum``
micro-batches a step. With ``--ckpt`` the params and optimizer state are
saved every ``--ckpt-every`` steps on a background thread, and a rerun
resumes from the newest valid checkpoint: a killed and resumed run ends
with the bits of an uninterrupted one (deterministic kernels, the batch
and the schedule a function of the step).

Checkpoints use the reference's on-disk format
(``repro_torch.distributed.checkpoint``). Runs on the GPU unless
``--device cpu`` is given.

Examples:
    PYTHONPATH=src python -m repro_torch.launch.train --mode tgn
    PYTHONPATH=src python -m repro_torch.launch.train --edges 600 \\
        --f-mem 8 --epochs 1 --device cpu --ckpt /tmp/tgn_ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --mode lm \\
        --arch qwen3_8b --steps 6 --batch 2 --seq 64 --ckpt /tmp/lm_ckpt \\
        --ckpt-every 3
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import tgn
from repro_torch.data import stream, temporal_graph as tgd
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import overlap
from repro_torch.models import lm_common
from repro_torch.training import optim as opt_mod
from repro_torch.training import tgn_trainer as TT
from repro_torch.training import train_loop as TL
from repro_torch.training.lr_schedule import ScheduleConfig
from repro_torch.utils import deterministic, resolve_device

#: the distilled students of Table II, each with its model axes
STUDENTS = (("+SAT", dict(attention="sat", encoder="cosine")),
            ("+LUT", dict(attention="sat", encoder="lut")),
            ("+NP(L)", dict(attention="sat", encoder="lut", prune_k=6)),
            ("+NP(M)", dict(attention="sat", encoder="lut", prune_k=4)),
            ("+NP(S)", dict(attention="sat", encoder="lut", prune_k=2)))


def run_tgn(args) -> dict:
    device = resolve_device(args.device)
    g = tgd.DATASETS[args.dataset](n_edges=args.edges)
    base = dict(n_nodes=g.cfg.n_nodes, n_edges=g.n_edges,
                f_edge=g.cfg.f_edge, f_feat=g.cfg.f_feat,
                f_mem=args.f_mem, f_time=args.f_mem, f_emb=args.f_mem,
                m_r=10)
    tcfg = TT.TGNTrainConfig(batch_size=args.batch, epochs=args.epochs)
    _, va, te = stream.chronological_split(g)
    warm = slice(0, va.stop)

    t_cfg = tgn.TGNConfig(**base)
    t0 = time.time()
    t_params, losses = TT.train_teacher(g, t_cfg, tcfg, device=device)
    ap_teacher = TT.evaluate_ap(t_params, t_cfg, g, te, warm_window=warm,
                                device=device)
    print(f"[teacher] AP={ap_teacher:.4f} loss {losses[0]:.3f}->"
          f"{losses[-1]:.3f} ({time.time()-t0:.0f}s)", flush=True)
    if args.ckpt:
        ckpt.save(args.ckpt + "/teacher", 0, t_params,
                  meta={"ap": ap_teacher})

    results = {"Baseline": ap_teacher}
    for name, kw in STUDENTS:
        s_cfg = tgn.TGNConfig(**base, **kw)
        t0 = time.time()
        s_params, _ = TT.distill_student(g, t_params, t_cfg, s_cfg, tcfg,
                                         device=device)
        ap = TT.evaluate_ap(s_params, s_cfg, g, te, warm_window=warm,
                            device=device)
        results[name] = ap
        print(f"[{name}] AP={ap:.4f} (diff {ap-ap_teacher:+.4f}) "
              f"({time.time()-t0:.0f}s)", flush=True)
        if args.ckpt:
            ckpt.save(args.ckpt + f"/student_{name}", 0, s_params,
                      meta={"ap": ap})
    return results


def lm_config(args):
    """``--preset 100m``'s transformer, else ``--arch``'s smoke config."""
    if args.preset == "100m":
        from repro_torch.models.transformer import LMConfig
        return LMConfig(arch="lm100m", n_layers=12, d_model=768, n_heads=12,
                        n_kv_heads=12, d_head=64, d_ff=3072, vocab=32_000,
                        dtype="float32", remat="none", q_block=128,
                        k_block=128, loss_chunk=128)
    return configs.get(args.arch).smoke_config()


def lm_batch(cfg, step: int, batch: int, seq: int) -> dict:
    """Step ``step``'s synthetic batch (numpy, seeded by the step): random
    tokens, the targets their left shift, fp32 frames or vision tokens
    for whisper and the vision LM."""
    rng = np.random.RandomState(1000 + step)
    toks = rng.randint(0, cfg.vocab, size=(batch, seq)).astype(np.int32)
    out = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    fam = lm_common.family_of(cfg)
    if fam == "whisper":
        out["frames"] = rng.randn(batch, cfg.n_frames,
                                  cfg.d_model).astype(np.float32)
    if fam == "vision_lm":
        out["vision"] = rng.randn(batch, cfg.n_patches,
                                  cfg.d_model).astype(np.float32)
    return out


def run_lm(args) -> dict:
    device = resolve_device(args.device)
    with deterministic():
        return _run_lm(args, device)


def _run_lm(args, device) -> dict:
    cfg = lm_config(args)
    print(f"[lm] arch={getattr(cfg, 'arch', args.arch)} "
          f"params~{cfg.n_params/1e6:.1f}M on {device}", flush=True)
    params = lm_common.init_params(
        torch.Generator(device=device).manual_seed(0), cfg, device)
    tcfg = TL.TrainConfig(
        optim=opt_mod.OptimConfig(lr=3e-4),
        sched=ScheduleConfig(warmup_steps=20, total_steps=args.steps),
        grad_accum=args.grad_accum)
    opt_state = TL.init_train_state(tcfg, params)
    step_fn = TL.make_train_step(
        lambda p, b: lm_common.loss_fn(p, cfg, b), tcfg)

    start = 0
    if args.ckpt and ckpt.list_steps(args.ckpt):
        tree, _, start = ckpt.restore_valid(
            args.ckpt, {"params": params, "opt": opt_state}, device=device)
        params, opt_state = tree["params"], tree["opt"]
        print(f"[lm] resumed from step {start}", flush=True)

    def batches():
        for i in range(start, args.steps):
            yield i, lm_batch(cfg, i, args.batch, args.seq)

    def put(item):
        i, b = item
        return i, {k: torch.as_tensor(v).to(device) for k, v in b.items()}

    losses = []
    t0 = time.time()
    saver = ckpt.AsyncCheckpointer(args.ckpt) if args.ckpt else None
    for i, batch in overlap.prefetch(batches(), 2, device_put=put):
        params, opt_state, metrics = step_fn(params, opt_state, batch, i)
        losses.append(float(metrics["loss"]))
        if (i + 1) % args.log_every == 0:
            tok_s = args.batch * args.seq * args.log_every / (
                time.time() - t0)
            print(f"step {i+1}: loss={losses[-1]:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"tok/s={tok_s:.0f}", flush=True)
            t0 = time.time()
        if saver and (i + 1) % args.ckpt_every == 0:
            saver.save(i + 1, {"params": params, "opt": opt_state},
                       meta={"loss": losses[-1]})
    if saver:
        saver.wait()
    if losses:
        print(f"[lm] final loss {losses[-1]:.4f} (start {losses[0]:.4f})",
              flush=True)
    return {"losses": losses, "start": start, "params": params,
            "opt": opt_state}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("tgn", "lm"), default="tgn")
    ap.add_argument("--dataset", default="wikipedia",
                    choices=tuple(tgd.DATASETS))
    ap.add_argument("--edges", type=int, default=4000)
    ap.add_argument("--f-mem", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch", type=int, default=100)
    ap.add_argument("--arch", default="qwen3_8b")
    ap.add_argument("--preset", default=None, choices=(None, "100m"))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt", default=None,
                    help="tgn: directory to save the teacher and each "
                    "student in; lm: checkpoint directory to save in and "
                    "resume from")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.mode == "lm":
        return run_lm(args)
    return run_tgn(args)


if __name__ == "__main__":
    main()
