"""Where a step's time goes on the GPU: device time by kernel and the
device's idle share, per kernel tier.

    PYTHONPATH=src python -m repro_torch.launch.profile
    PYTHONPATH=src python -m repro_torch.launch.profile --variant teacher \\
        sat+cosine
    PYTHONPATH=src python -m repro_torch.launch.profile --variant ladder
    PYTHONPATH=src python -m repro_torch.launch.profile --train
    PYTHONPATH=src python -m repro_torch.launch.profile --fleet
    PYTHONPATH=src python -m repro_torch.launch.profile --lm-train
    PYTHONPATH=src python -m repro_torch.launch.profile --sat-logits
    PYTHONPATH=src python -m repro_torch.launch.profile --peek

Without ``--variant`` it builds the main-path configurations
(``launch/main_path.py``: the student on the Wikipedia path, then on the
GDELT-like path); with it, the named registry variants (``ladder``: all of
``main_path.LADDER``) on the Wikipedia path, each on the tiers that
resolve to distinct programs (a fused request outside the fused step's
coverage runs the staged tier, so it is not traced twice). It warms each
tier's
StreamingEngine up on 10 batches, then traces the next 20 with
``torch.profiler`` (device activity only). For each path and tier (ref,
staged, fused on the Wikipedia path; ref and staged on the GDELT-like
path, whose fused request runs the staged tier) it prints the wall time
per step (host clock around each step, which ends in a synchronize), the
device-busy time per step (union of the kernel and copy intervals), the
idle share, the device operations per step, the port's kernel launches
per step (``kernels.ops`` counts), the 12 kernels that take the most
device time, and the time per step of each of the port's kernels (by
kernel function, so fused_step's three kernels show apart). ``--train``
traces training instead: a teacher step and a distill step of the
student at paper width on ``main_path.train_graph`` (B = 100), each
warmed up for 10 steps and traced for the next 20, with the same report.
``--fleet`` traces serving rounds of a multi-tenant session instead: the
mixed fleet of ``main_path.FLEET`` (8 tenants, 5 cohorts), then one np4
fused lane of 1, 8 and 16 tenants, each warmed up for 5 rounds, timed
over 20 rounds without the profiler (the wall time and idle share it
reports: the profiler's own cost inflates a traced round's wall time
several-fold at this rate of device operations) and traced over the next
20; "step" in the report is then a round. ``--sat-logits`` isolates the
cost of ``attention.sat_logits``'s row-independent form (an elementwise
product and a sum) against the matrix product it replaced
(``matmul_sat_logits``) and a slot-by-slot sum (``slot_sum_sat_logits``)
on the Wikipedia path: each form alone at the path's input (2B x m_r),
device ops and device us a call (traced) and host us a call; then each
tier's step traced with each form in turn, twice. ``--peek`` times the engine's
``step_on_device`` (a step on a copy of the tables) against ``process``
on the same batches and state, per tier, host clock, synchronized.
``--lm-train`` traces language-model training steps at chip_smoke's
shapes (``main_path.LM_TRAIN_MAMBA``, ``LM_TRAIN_QWEN``): mamba2-130m
uncut at 4 x 2,048 and qwen3-8b at full width with 4 layers at 1 x
4,096, each warmed up for one step and traced for ``LM_STEPS``, under
deterministic algorithms as ``--mode lm`` runs. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import re
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.stages import KERNEL_TIERS, resolved_tier
from repro_torch.data import stream
from repro_torch.kernels import ops
from repro_torch.launch import main_path
from repro_torch.serving.engine import EngineConfig, StreamingEngine
from repro_torch.utils import resolve_device

WARMUP = 10
STEPS = 20
TOP = 12
LM_STEPS = 2
#: the port's kernel functions (kernels/csrc), as the profiler names them
PORT_KERNELS = ("lut_encode_kernel", "gru_cell_kernel",
                "sat_aggregate_kernel", "fused_muu_kernel", "fused_eu_kernel",
                "fused_out_kernel")


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def profile_tier(path, tier, cfg, params, g, device):
    eng = StreamingEngine(EngineConfig(model=cfg, use_kernels=tier), params,
                          g.edge_feats, g.node_feats, device=device)
    B = main_path.B
    batches = list(stream.fixed_count(
        g, B, window=slice(0, (WARMUP + STEPS) * B)))
    for b in batches[:WARMUP]:
        eng.process(b)
    n0 = len(eng.metrics)
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for b in batches[WARMUP:]:
            eng.process(b)
    launches = sum(ops.launch_counts().values()) / STEPS
    wall_ms = sum(m["latency_s"] for m in eng.metrics[n0:]) * 1e3 / STEPS
    report(f"{path} {tier}", prof, wall_ms, launches)


def report(name, prof, wall_ms, launches, steps: int = STEPS) -> None:
    """Print a traced window's per-step wall and device-busy time, idle
    share, device ops, the top kernels and the port's kernels, over
    ``steps`` traced steps."""
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise RuntimeError("the profiler recorded no device events")
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    busy_ms = busy_us((e.time_range.start, e.time_range.end)
                      for e in events) / 1e3 / steps
    print(f"profile {name}: wall {wall_ms:.3f} ms/step, device busy "
          f"{busy_ms:.3f} ms/step, idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{len(events) / steps:.1f} device ops/step, {launches:g} port "
          f"kernel launches/step", flush=True)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for kname, (n, us) in ranked[:TOP]:
        print(f"  {us / steps:9.2f} us/step  {n / steps:5.1f}x  {kname[:90]}")
    port = collections.defaultdict(float)
    for kname, (_, us) in by_name.items():
        m = re.search("|".join(PORT_KERNELS), kname)
        if m:
            port[m.group(0)] += us / steps
    print(f"profile {name}: port kernels us/step "
          f"{ {k: round(v, 2) for k, v in sorted(port.items())} }",
          flush=True)


def profile_training(device) -> None:
    """A teacher step and a distill step of the student, traced."""
    from repro_torch.core import tgn
    from repro_torch.training import optim
    from repro_torch.training import tgn_trainer as TT

    g = main_path.train_graph()
    t_cfg = main_path.config(g, "vanilla+cosine")
    s_cfg = main_path.config(g, main_path.STUDENT)
    tcfg = TT.TGNTrainConfig(batch_size=main_path.TRAIN_B)
    nf, ef = TT.features(g, t_cfg, device)
    ocfg = optim.OptimConfig(name="adamw", lr=tcfg.lr, weight_decay=0.0)
    train_sl, _, _ = stream.chronological_split(g)
    batches = [TT.batch_tensors(b, device) for b in stream.fixed_count(
        g, main_path.TRAIN_B, window=slice(0, (WARMUP + STEPS)
                                           * main_path.TRAIN_B))]
    t_params = tgn.init_params(torch.Generator().manual_seed(0), t_cfg,
                               device)
    s_params = tgn.init_params(torch.Generator().manual_seed(7), s_cfg,
                               device, dt_samples=TT._dt_samples(g, train_sl))
    teacher = TT.make_teacher_step(t_cfg, ocfg, nf, ef)
    distill = TT.make_distill_step(s_cfg, t_cfg, ocfg, tcfg, nf, ef)
    runs = {
        # step, its carried arguments, the next carry from its outputs
        "teacher vanilla+cosine": (
            teacher, [t_params, optim.init_state(ocfg, t_params),
                      tgn.init_state(t_cfg, device)],
            lambda c, out: list(out[:3])),
        f"distill {main_path.STUDENT}": (
            distill, [s_params, t_params, optim.init_state(ocfg, s_params),
                      tgn.init_state(s_cfg, device),
                      tgn.init_state(t_cfg, device)],
            lambda c, out: [out[0], c[1], *out[1:4]]),
    }
    for name, (step, carry, nxt) in runs.items():
        for b in batches[:WARMUP]:
            carry = nxt(carry, step(*carry, b))
        torch.cuda.synchronize()
        wall = 0.0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for b in batches[WARMUP:]:
                t0 = time.perf_counter()
                carry = nxt(carry, step(*carry, b))
                torch.cuda.synchronize()
                wall += time.perf_counter() - t0
        report(f"train {name}", prof, wall * 1e3 / STEPS, 0)


def profile_lm_training(device) -> None:
    """Training steps of mamba2-130m and of qwen3-8b (4 layers) at the
    LM-training phase's shapes, traced."""
    from repro_torch import configs
    from repro_torch.launch import lm_train_smoke as LTS
    from repro_torch.models import lm_common
    from repro_torch.training import train_loop as TL
    from repro_torch.utils import deterministic

    qwen = main_path.LM_TRAIN_QWEN
    runs = ((configs.get(main_path.LM_TRAIN_MAMBA["arch"]).config(),
             main_path.LM_TRAIN_MAMBA),
            (configs.get(qwen["arch"]).config().replace(
                n_layers=qwen["n_layers"], remat="nothing"), qwen))
    with deterministic():
        for cfg, spec in runs:
            B, S = spec["batch"], spec["seq"]
            params = lm_common.init_params(
                torch.Generator(device=device).manual_seed(0), cfg, device)
            tcfg = LTS.lm_step_config(LM_STEPS + 1)
            step = TL.make_train_step(
                lambda p, b, c=cfg: lm_common.loss_fn(p, c, b), tcfg)
            opt = TL.init_train_state(tcfg, params)
            batches = [LTS.batch_on(cfg, i, B, S, device)
                       for i in range(LM_STEPS + 1)]
            params, opt, _ = step(params, opt, batches[0], 1)
            torch.cuda.synchronize()
            wall = 0.0
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for i in range(1, LM_STEPS + 1):
                    t0 = time.perf_counter()
                    params, opt, _ = step(params, opt, batches[i], i + 1)
                    torch.cuda.synchronize()
                    wall += time.perf_counter() - t0
            report(f"lm train {cfg.arch} B x S = {B} x {S}", prof,
                   wall * 1e3 / LM_STEPS, 0, steps=LM_STEPS)
            del params, opt, batches, prof
            torch.cuda.empty_cache()


def profile_fleet(device) -> None:
    """Rounds of the mixed fleet and of one np4 fused lane at T = 1, 8,
    16: the wall time of a round (host clock around it, synchronized) from
    an untraced window, the device's side from a traced one."""
    g = main_path.wikipedia_graph()
    fleets = {"mixed": main_path.FLEET}
    for T in (1, 8, 16):
        fleets[f"np4 fused x{T}"] = ((main_path.STUDENT, "fused", None),) * T
    for name, lanes in fleets.items():
        mgr, tids = main_path.fleet_session(g, device, lanes)
        warm = 5
        feeds = main_path.fleet_feeds(g, len(tids), warm + 2 * STEPS)

        def round_(r):
            t0 = time.perf_counter()
            mgr.step({t: feeds[i][r] for i, t in enumerate(tids)})
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        for r in range(warm):
            round_(r)
        wall = sum(round_(r) for r in range(warm, warm + STEPS))
        ops.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            traced = sum(round_(r) for r in range(warm + STEPS,
                                                  warm + 2 * STEPS))
        print(f"profile fleet {name}: traced wall {traced * 1e3 / STEPS:.3f}"
              f" ms/round, untraced {wall * 1e3 / STEPS:.3f}", flush=True)
        report(f"fleet {name} ({len(tids)} tenants, "
               f"{len(mgr.describe())} cohorts)", prof, wall * 1e3 / STEPS,
               sum(ops.launch_counts().values()) / STEPS)
        del mgr
        torch.cuda.empty_cache()


def matmul_sat_logits(params: dict, dt_nbr: torch.Tensor) -> torch.Tensor:
    """``attention.sat_logits`` as one matrix product (its rows may depend
    on the row count: cuBLAS picks its algorithm by the shape)."""
    return params["a"] + torch.log1p(dt_nbr.clamp(min=0.0)) @ params["w_t"].T


def slot_sum_sat_logits(params: dict, dt_nbr: torch.Tensor) -> torch.Tensor:
    """``attention.sat_logits`` summed slot by slot: m_r elementwise
    operations."""
    dtf = torch.log1p(dt_nbr.clamp(min=0.0))
    w_t = params["w_t"]
    acc = dtf[..., :1] * w_t[:, 0]
    for k in range(1, w_t.shape[1]):
        acc = torch.addcmul(acc, dtf[..., k:k + 1], w_t[:, k])
    return params["a"] + acc


def profile_sat_logits(device) -> None:
    """The forms of sat_logits alone, then in every tier's step."""
    from repro_torch.core import attention
    shipped = attention.sat_logits
    forms = {"mul+sum": shipped, "matmul": matmul_sat_logits,
             "slot sum": slot_sum_sat_logits}
    g, cfg, params = main_path.build(device)
    dt = torch.rand((2 * main_path.B, cfg.m_r), generator=torch.Generator(
        device=device).manual_seed(0), device=device) * 1e5
    for name, fn in forms.items():
        for _ in range(WARMUP):
            fn(params["attn"], dt)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(STEPS):
                fn(params["attn"], dt)
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_us = sum(e.time_range.elapsed_us() for e in events) / STEPS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn(params["attn"], dt)
        torch.cuda.synchronize()
        host_us = (time.perf_counter() - t0) * 1e6 / 200
        print(f"sat_logits {name} at {tuple(dt.shape)}: "
              f"{len(events) / STEPS:g} device ops a call, device "
              f"{dev_us:.2f} us a call, {host_us:.2f} us a call issued "
              "back to back", flush=True)
    try:
        for tier in KERNEL_TIERS:
            for name in tuple(forms) * 2:
                attention.sat_logits = forms[name]
                profile_tier(f"wikipedia sat_logits={name}", tier, cfg,
                             params, g, device)
    finally:
        attention.sat_logits = shipped


def profile_peek(device) -> None:
    """``step_on_device`` against ``process`` on the same batches."""
    g, cfg, params = main_path.build(device)
    B = main_path.B
    batches = list(stream.fixed_count(
        g, B, window=slice(0, (WARMUP + STEPS) * B)))
    for tier in KERNEL_TIERS:
        eng = StreamingEngine(EngineConfig(model=cfg, use_kernels=tier),
                              params, g.edge_feats, g.node_feats,
                              device=device)
        for b in batches[:WARMUP]:
            eng.process(b)
        peek_s, proc_s = [], []
        for b in batches[WARMUP:]:
            dev = tuple(torch.as_tensor(x, device=device) for x in
                        (b.src, b.dst, b.eid, b.ts, b.valid))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.step_on_device(dev)
            torch.cuda.synchronize()
            peek_s.append(time.perf_counter() - t0)
            eng.process(b)
            proc_s.append(eng.metrics[-1]["latency_s"])
        table_mb = sum(t.numel() * t.element_size()
                       for t in eng.session.cohort_of(eng.tid).state) / 1e6
        peek_ms = sorted(peek_s)[STEPS // 2] * 1e3
        proc_ms = sorted(proc_s)[STEPS // 2] * 1e3
        print(f"peek {tier}: step_on_device median {peek_ms:.3f} ms, "
              f"process median {proc_ms:.3f} ms "
              f"({peek_ms - proc_ms:+.3f} ms; the copy is of "
              f"{table_mb:.2f} MB of tables)", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", nargs="+", default=None,
                    help="registry names or aliases to trace on the "
                         "Wikipedia path, or 'ladder' for all of "
                         "main_path.LADDER")
    ap.add_argument("--train", action="store_true",
                    help="trace training steps (teacher, distill) instead")
    ap.add_argument("--fleet", action="store_true",
                    help="trace multi-tenant serving rounds instead")
    ap.add_argument("--sat-logits", action="store_true",
                    help="isolate sat_logits' forms (product and sum, "
                         "matmul, slot sum)")
    ap.add_argument("--peek", action="store_true",
                    help="time step_on_device against process")
    ap.add_argument("--lm-train", action="store_true",
                    help="trace language-model training steps instead")
    args = ap.parse_args(argv)
    device = resolve_device()
    if args.lm_train:
        profile_lm_training(device)
        return
    if args.sat_logits or args.peek:
        if args.sat_logits:
            profile_sat_logits(device)
        if args.peek:
            profile_peek(device)
        return
    if args.train:
        profile_training(device)
        return
    if args.fleet:
        profile_fleet(device)
        return
    if args.variant is None:
        for path, build, tiers in (
                ("wikipedia", main_path.build, KERNEL_TIERS),
                ("gdelt", main_path.build_gdelt, ("ref", "staged"))):
            g, cfg, params = build(device)
            for tier in tiers:
                profile_tier(path, tier, cfg, params, g, device)
        return
    names = (main_path.LADDER if args.variant == ["ladder"]
             else args.variant)
    g = main_path.wikipedia_graph()
    for name in names:
        cfg, params = main_path.model(g, name, device)
        tiers = [t for t in KERNEL_TIERS if resolved_tier(cfg, t) == t]
        for tier in tiers:
            profile_tier(f"wikipedia {name}", tier, cfg, params, g, device)


if __name__ == "__main__":
    main()
