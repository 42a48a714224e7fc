"""Multi-pod dry run: trace every (arch x shape x mesh) cell on DTensors.

Port of ``repro.launch.dryrun``. Where the reference lowers and compiles
each cell under GSPMD over 512 placeholder devices, the port runs the
cell's step on DTensors: a fake process group of 256 or 512 ranks
(``torch.testing._internal.distributed.fake_pg``, backend ``"fake"``; this
process is rank 0), a ``DeviceMesh`` of ``make_production_mesh``'s shape
and axis names, and ``meta`` local tensors, so nothing is allocated and
no collective moves data. DTensor lowers each op to rank 0's local op and
issues the collectives its placements need; ``hlo_analysis.record`` traces
them (folding the models' loops), and ``hlo_analysis.analyze`` gives the
per-device FLOPs, bytes and collective bytes.

A spec entry that names mesh axes becomes ``Shard(dim)`` on each of those
mesh dimensions and ``Replicate()`` on every other
(``sharding.placements``); ``sharding.constrain`` redistributes the
activations to the installed rules, as the reference's
``with_sharding_constraint`` does. An op DTensor has no strategy for
runs with every input replicated (``hlo_analysis.Recorder._dtensor_op``),
as does an op whose strategies cannot keep an in-place operand's
placement (an in-place write into a sharded dimension is the owning
shard's local update): the all-gathers are counted and the cell names the
op in ``replicated_ops``. No op is dropped. The view ops are made
non-strict for the cell (``_NonStrictViews``).

Each cell's record has the reference's keys, with ``trace_s`` for
``lower_s``/``compile_s``, ``flop_counter`` (what ``FlopCounterMode``
counts of the same step, over the DTensors' global shapes, each folded
loop body counted as often as it ran, as XLA's cost analysis visits a
while body once; ``hlo_analysis.record`` applies its formulas) for
``xla_cost_analysis``, and ``memory`` from the trace:
``argument_bytes`` by spec arithmetic (``sharding.per_device_bytes``),
``output_bytes``, ``temp_bytes`` and ``peak_bytes`` from the trace's live
storages. ``roofline`` is on ``perf_model.H100_SXM``: its compute term
sums over precisions (products at their operand dtype, everything else at
fp32), its collective term uses one NVLink's 900 GB/s, which is
optimistic for a mesh axis that spans nodes. ``fits``: ``peak_bytes``
within the card's 80 GB. ``folds``: the loops folded (site -> trips).

The mesh's device type is ``cuda`` unless the caller passes
``device="cpu"`` (without a card, ``cuda`` raises, as the port's other
entry points do); the process group is made on first use and destroyed by
``destroy_world``.

Usage:
    python -m repro_torch.launch.dryrun --arch gemma3_12b --shape train_4k
    python -m repro_torch.launch.dryrun --arch all --shape all \\
        --both-meshes --device cpu --out results/dryrun_torch
"""
from __future__ import annotations

import argparse
import gzip
import json
import math
import os
import time
import traceback

import torch

from repro_torch import configs
from repro_torch import tree as tree_mod
from repro_torch.core import perf_model
from repro_torch.distributed import sharding as shd
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm_common
from repro_torch.training import optim as opt_mod
from repro_torch.training.lr_schedule import ScheduleConfig, schedule
from repro_torch.utils import resolve_device

META = torch.device("meta")


# ---------------------------------------------------------------------------
# the fake world and its meshes
# ---------------------------------------------------------------------------


def _world(n: int) -> None:
    """A fake process group of ``n`` ranks, this process rank 0 (made anew
    when one of another size is up)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def destroy_world() -> None:
    """Destroy the fake process group, if one is up, and drop what DTensor
    cached on its meshes: a later world's mesh of the same shape compares
    equal to them, and their specs name the destroyed groups (some
    propagations were also made with the dry run's non-strict views)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import _redistribute
    prop = DTensor._op_dispatcher.sharding_propagator
    clears = [getattr(getattr(owner, name, None), "cache_clear", None)
              for owner, name in (
                  (prop, "propagate_op_sharding"),
                  (type(prop), "_propagate_tensor_meta_cached"),
                  (_redistribute, "_gen_transform_infos"))]
    clears += [getattr(_redistribute, "clear_redistribute_planner_cache",
                       None),    # these two are not in every torch
               getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                       None)]
    for clear in clears:
        if clear is not None:
            clear()


def device_mesh(mesh, device: str = "cuda"):
    """A ``DeviceMesh`` of ``mesh``'s shape and axis names (a
    ``TenantMesh``) over the fake world's ranks, ``device``-typed."""
    from torch.distributed.device_mesh import DeviceMesh
    shape = tuple(mesh.devices.shape)
    _world(math.prod(shape))
    return DeviceMesh(device, torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=tuple(mesh.axis_names))


def _shardify(dmesh, mesh, leaves_tree, spec_tree):
    """Each ``meta`` leaf as a DTensor placed by its spec: a ``meta`` local
    of rank 0's shard shape."""
    from torch.distributed.tensor import DTensor
    specs = tree_mod.leaves(spec_tree, is_leaf=shd._is_spec)
    leaves = tree_mod.leaves(leaves_tree)
    out = []
    for leaf, spec in zip(leaves, specs):
        spec = tuple(spec) + (None,) * (leaf.ndim - len(spec))
        local = torch.empty(shd.shard_shape(tuple(leaf.shape), spec, mesh),
                            dtype=leaf.dtype, device=META)
        out.append(DTensor.from_local(
            local, dmesh, shd.placements(spec, dmesh.mesh_dim_names),
            run_check=False, shape=leaf.shape,
            stride=torch.empty(leaf.shape, device=META).stride()))
    return tree_mod.unflatten(leaves_tree, out)


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


def _opt_state_specs(opt_abs, params_abs, mode, n_model):
    z1 = shd.zero1_specs(params_abs, mode, n_model)
    p_leaves = tree_mod.leaves(params_abs)
    out = {"step": ()}
    for k in ("m", "v"):
        if k not in opt_abs:
            continue
        if len(tree_mod.leaves(opt_abs[k])) == len(p_leaves):
            out[k] = z1
        else:  # QTensor moments: flat int8 payloads + scales. Payload
            # length is always a _QBLOCK (=256) multiple -> shard over the
            # full (data x model) = 256 chips; scales over data when they
            # divide.
            def qspec(leaf):
                n = leaf.shape[0] if leaf.ndim == 1 else 0
                if n and n % 256 == 0:
                    return (("data", "model"),)
                if n and n % 16 == 0 and n >= 16:
                    return ("data",)
                return ()
            out[k] = tree_mod.map(qspec, opt_abs[k],
                                  is_leaf=lambda x: isinstance(
                                      x, torch.Tensor))
    return out


def _grads(loss_fn, params, batch):
    """``(loss, grads)`` over every leaf of ``params`` (a leaf the loss
    does not reach gets zeros, as under ``jax.value_and_grad``)."""
    live = [p.detach().requires_grad_(True) for p in tree_mod.leaves(params)]
    loss = loss_fn(tree_mod.unflatten(params, live), batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)]
    return loss.detach(), tree_mod.unflatten(params, grads)


def build_train_cell(spec, cfg, mesh, seq_len, global_batch):
    """-> (fn, abstract args, in_specs, out_specs, donate)."""
    mode = spec.shard_mode
    n_model = mesh.shape["model"]
    ocfg = opt_mod.OptimConfig(moment_dtype=spec.moment_dtype)
    scfg = ScheduleConfig()

    params_abs = lm_common.abstract_params(cfg)
    opt_abs = opt_mod.init_state(ocfg, params_abs)
    batch_abs = lm_common.train_inputs(cfg, global_batch, seq_len)

    p_specs = shd.param_specs(params_abs, mode, n_model)
    o_specs = _opt_state_specs(opt_abs, params_abs, mode, n_model)
    b_specs = tree_mod.map(
        lambda leaf: shd.batch_spec(mesh, global_batch, leaf.ndim),
        batch_abs)

    accum = spec.grad_accum

    def train_step(params, opt_state, batch, step_idx):
        def loss_of(p, b):
            return lm_common.loss_fn(p, cfg, b)

        if accum > 1:
            # micro-batch j: rows j, j + accum, ... -- each device splits
            # its own rows (the reference's contiguous split moves none
            # either: GSPMD keeps the split local)
            def micro(x, j):
                b = x.shape[0]
                return x.reshape(b // accum, accum, *x.shape[1:])[:, j]

            loss = None
            grads = None
            for j in range(accum):
                lj, gj = _grads(loss_of, params,
                                {k: micro(v, j) for k, v in batch.items()})
                if grads is None:
                    loss = lj
                    grads = tree_mod.map(lambda g: g.to(torch.float32), gj)
                else:
                    loss = loss + lj
                    grads = tree_mod.map(torch.add, grads, gj)
            loss = loss / accum
            grads = tree_mod.map(lambda g: g / accum, grads)
        else:
            loss, grads = _grads(loss_of, params, batch)

        lr_scale = schedule(scfg, step_idx)
        opt_state, params = opt_mod.apply_updates(ocfg, opt_state, grads,
                                                  params, lr_scale)
        return params, opt_state, loss

    args = (params_abs, opt_abs, batch_abs,
            torch.empty((), dtype=torch.int32, device=META))
    in_specs = (p_specs, o_specs, b_specs, ())
    out_specs = (p_specs, o_specs, ())
    return train_step, args, in_specs, out_specs, (0, 1)


def build_decode_cell(spec, cfg, mesh, seq_len, global_batch,
                      params_bf16: bool = False):
    mode = spec.shard_mode
    n_model = mesh.shape["model"]
    params_abs = lm_common.abstract_params(cfg)
    if params_bf16:  # §Perf O1: serving weights stored bf16
        params_abs = tree_mod.map(
            lambda leaf: (torch.empty(leaf.shape, dtype=torch.bfloat16,
                                      device=META)
                          if leaf.dtype == torch.float32 else leaf),
            params_abs)
    batch_abs = lm_common.decode_inputs(cfg, global_batch, seq_len)

    p_specs = shd.param_specs(params_abs, mode, n_model)
    tok_spec = shd.batch_spec(mesh, global_batch, 2)
    cache_specs = tree_mod.map(
        lambda leaf: shd.cache_spec(mesh, tuple(leaf.shape), global_batch),
        batch_abs["caches"])
    b_specs = {"token": tok_spec, "caches": cache_specs}

    def serve_step(params, batch):
        return lm_common.decode_fn(params, cfg, batch)

    logits_spec = shd.batch_spec(mesh, global_batch, 2)
    args = (params_abs, batch_abs)
    return (serve_step, args, (p_specs, b_specs), (logits_spec, cache_specs),
            (1,))


def build_prefill_cell(spec, cfg, mesh, seq_len, global_batch):
    mode = spec.shard_mode
    n_model = mesh.shape["model"]
    params_abs = lm_common.abstract_params(cfg)
    batch_abs = lm_common.train_inputs(cfg, global_batch, seq_len)
    batch_abs.pop("targets")

    p_specs = shd.param_specs(params_abs, mode, n_model)
    b_specs = tree_mod.map(
        lambda leaf: shd.batch_spec(mesh, global_batch, leaf.ndim),
        batch_abs)

    fam = lm_common.family_of(cfg)
    mod = lm_common.FAMILIES[fam]

    def prefill_step(params, batch):
        if fam == "whisper":
            logits, _ = mod.prefill(params, cfg, batch["frames"],
                                    batch["tokens"])
        elif fam == "vision_lm":
            logits, _ = mod.prefill(params, cfg, batch["tokens"],
                                    batch["vision"])
        else:
            logits, _ = mod.prefill(params, cfg, batch["tokens"])
        return logits

    args = (params_abs, batch_abs)
    return (prefill_step, args, (p_specs, b_specs),
            shd.batch_spec(mesh, global_batch, 2), ())


# ---------------------------------------------------------------------------
# ops without a DTensor strategy
# ---------------------------------------------------------------------------

class _NonStrictViews:
    """DTensor's view ops non-strict for the duration of a cell: a view
    that splits a sharded dimension unevenly (a GQA projection's 8 kv
    heads over the model axis's 16 devices) reshards its input, as GSPMD
    does, instead of raising."""

    def __init__(self):
        from torch.distributed.tensor import DTensor
        self.prop = DTensor._op_dispatcher.sharding_propagator

    def __enter__(self):
        from torch.distributed.tensor._ops import _view_ops
        self._saved = dict(self.prop.op_strategy_funcs)
        aten = torch.ops.aten
        for op in (aten.view.default, aten._unsafe_view.default):
            _view_ops.register_op_strategy_map(
                op, torch.Tensor.view,
                schema_info=self.prop.op_to_schema_info.get(op),
                strict_view=False)
        return self

    def __exit__(self, *exc):
        self.prop.op_strategy_funcs.clear()
        self.prop.op_strategy_funcs.update(self._saved)
        return False


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------


def _bound(stats: dict, chip=perf_model.H100_SXM):
    """Roofline terms: products at their operand dtype's peak (bf16 on the
    tensor cores, fp32 on the CUDA cores), every other FLOP at fp32."""
    peak = {"bf16": chip.bf16_flops, "f16": chip.bf16_flops}
    product = sum(stats["flops_by_dtype"].values())
    compute = (stats["flops"] - product) / chip.fp32_flops + sum(
        f / peak.get(dt, chip.fp32_flops)
        for dt, f in stats["flops_by_dtype"].items())
    return perf_model.RooflineTerms(
        compute_s=compute,
        memory_s=stats["bytes"] / chip.hbm_bytes_per_s,
        collective_s=stats["collective_bytes"] / chip.link_bytes_per_s)


def per_device(stats: dict) -> dict:
    return {"flops": stats["flops"], "bytes": stats["bytes"],
            "collective_bytes": stats["collective_bytes"],
            "collectives_by_op": stats["collectives_by_op"],
            "collectives_count": stats["collectives_count"],
            "flops_by_dtype": stats["flops_by_dtype"],
            "bytes_by_kind": stats["bytes_by_kind"],
            "top_bytes_ops": stats["top_bytes_ops"]}


def roofline_of(stats: dict) -> dict:
    rl = _bound(stats)
    return {"compute_s": rl.compute_s, "memory_s": rl.memory_s,
            "collective_s": rl.collective_s, "bound": rl.bound}


class Cell:
    """A cell's step, its ``meta`` arguments, their specs and mesh
    (``build_cell``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def build_cell(arch: str, shape: str, *, multi_pod: bool = False,
               override_cfg=None, params_bf16: bool = False, mesh=None,
               seq_len: int | None = None, global_batch: int | None = None):
    """A cell's step and arguments with their per-device bytes by spec
    arithmetic (``sharding.per_device_bytes``), nothing traced; or the
    reference's skip record for ``long_500k`` on a pure full-attention
    arch."""
    spec = configs.get(arch)
    cfg = override_cfg or spec.config()
    s_len, g_batch, kind = configs.SHAPES[shape]
    seq_len = seq_len or s_len
    global_batch = global_batch or g_batch

    if shape == "long_500k" and not lm_common.supports_long_context(cfg):
        return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                "status": "skip(full-attn)",
                "note": "pure full-attention arch; see DESIGN.md §5"}

    if mesh is None:
        n = 512 if multi_pod else 256
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    devices=[META] * n)
    if kind == "train":
        fn, args, in_specs, _, _ = build_train_cell(spec, cfg, mesh, seq_len,
                                                    global_batch)
    elif kind == "decode":
        fn, args, in_specs, _, _ = build_decode_cell(
            spec, cfg, mesh, seq_len, global_batch, params_bf16=params_bf16)
    else:
        fn, args, in_specs, _, _ = build_prefill_cell(
            spec, cfg, mesh, seq_len, global_batch)
    return Cell(spec=spec, cfg=cfg, kind=kind, seq_len=seq_len,
                global_batch=global_batch, mesh=mesh, fn=fn, args=args,
                in_specs=in_specs, argument_bytes=sum(
                    shd.per_device_bytes(a, s, mesh)
                    for a, s in zip(args, in_specs)))


def cache_gathers(cell, ops) -> list:
    """The all-gathers in a decode cell's trace ``ops`` (a ``record``
    trace's ``ops``) whose operand is a K/V cache leaf's shard, whole or
    a layer's view of it, taken from the step's inputs: none when the
    sequence-sharded caches stay in place (``distributed/partitioned``).
    ``cell`` is ``build_cell``'s."""
    shards = set()
    if cell.kind == "decode":
        specs = tree_mod.leaves(cell.in_specs[1]["caches"],
                                is_leaf=shd._is_spec)
        for (path, leaf), spec in zip(
                tree_mod.flatten_with_path(cell.args[1]["caches"]), specs):
            if path.endswith((".k", ".v")):
                piece = shd.shard_shape(tuple(leaf.shape), spec, cell.mesh)
                shards |= {piece, piece[1:]}
    return [e for e in ops if e.get("coll") == "all_gather_into_tensor"
            and e["in"][0][2] and tuple(e["in"][0][0]) in shards]


def run_cell(arch: str, shape: str, *, multi_pod: bool = False,
             save_hlo: str | None = None, override_cfg=None,
             extra_rules: dict | None = None, params_bf16: bool = False,
             device=None, mesh=None, seq_len: int | None = None,
             global_batch: int | None = None) -> dict:
    """One cell's record. The mesh's devices are ``device``'s type:
    ``cuda`` unless the caller names another (raises without a card).
    ``mesh`` (a ``TenantMesh`` over ``("data", "model")`` or ``("pod",
    "data", "model")``) replaces the production mesh, ``seq_len`` /
    ``global_batch`` the shape's."""
    from torch.distributed.tensor.experimental import implicit_replication
    dev_type = resolve_device(device).type
    cell = build_cell(arch, shape, multi_pod=multi_pod,
                      override_cfg=override_cfg, params_bf16=params_bf16,
                      mesh=mesh, seq_len=seq_len, global_batch=global_batch)
    if isinstance(cell, dict):
        return cell
    kind, mesh = cell.kind, cell.mesh
    dmesh = device_mesh(mesh, dev_type)
    dp = shd.dp_axes(mesh)
    rules = {"carry": (dp, "model", None)} if kind == "train" else {}
    if extra_rules:
        rules.update(extra_rules)

    def step(*dargs):
        with torch.no_grad() if kind != "train" else torch.enable_grad():
            return cell.fn(*dargs)

    t0 = time.time()
    shd.set_activation_rules(rules, mesh)
    try:
        with _NonStrictViews():
            dargs = [_shardify(dmesh, mesh, a, s)
                     for a, s in zip(cell.args, cell.in_specs)]
            param_bytes = sum(t._local_tensor.untyped_storage().nbytes()
                              for t in tree_mod.leaves(dargs[0]))
            with implicit_replication():
                trace = hlo_analysis.record(step, *dargs)
    finally:
        shd.set_activation_rules({})
    t_trace = time.time() - t0
    del dargs

    if save_hlo:
        with gzip.open(save_hlo, "wt") as f:
            json.dump(trace, f)
    stats = hlo_analysis.analyze(trace)

    n_chips = math.prod(mesh.devices.shape)
    tokens = cell.global_batch * (cell.seq_len if kind != "decode" else 1)
    cfg = cell.cfg
    n_active = getattr(cfg, "n_active_params", cfg.n_params)
    mf = perf_model.model_flops(n_active, tokens, training=(kind == "train"))
    traced = trace["memory"]
    mem = {"argument_bytes": cell.argument_bytes,
           "output_bytes": traced["output_bytes"],
           "temp_bytes": traced["temp_bytes"],
           "peak_bytes": traced["peak_bytes"] - traced["argument_bytes"]
           + cell.argument_bytes,
           # the DTensor locals' own bytes: all inputs, and the parameters
           "local_argument_bytes": traced["argument_bytes"],
           "param_bytes": param_bytes}
    return {
        "arch": arch, "shape": shape, "multi_pod": multi_pod,
        "status": "ok",
        "kind": kind, "n_chips": n_chips,
        "seq_len": cell.seq_len, "global_batch": cell.global_batch,
        "trace_s": round(t_trace, 1),
        "memory": mem,
        "flop_counter": {"flops": trace["flop_counter"]},
        "per_device": per_device(stats),
        "roofline": roofline_of(stats),
        "model_flops_total": mf,
        "model_flops_per_device": mf / n_chips,
        "useful_compute_ratio": (mf / n_chips) / max(stats["flops"], 1.0),
        "fits": mem["peak_bytes"] <= perf_model.H100_SXM.hbm_bytes,
        "folds": trace["folds"],
        "replicated_ops": trace["replicated_ops"],
    }


def _tag(arch, shape, mp) -> str:
    return f"{arch}__{shape}__{'2pod' if mp else '1pod'}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None, help="JSON output directory")
    ap.add_argument("--device", default=None,
                    help="the mesh's device type: cuda (default) or cpu")
    args = ap.parse_args(argv)

    archs = configs.all_archs() if args.arch == "all" else [args.arch]
    shapes = list(configs.SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multipod]

    # sweep-level observability: trace walls as a streaming histogram +
    # ok/skip/fail counters, one snapshot at the end
    from repro_torch.obs import MetricsRegistry
    obs = MetricsRegistry()

    t_sweep = time.time()
    results = []
    try:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    tag = f"{arch}/{shape}/{'2pod' if mp else '1pod'}"
                    out_path = None
                    if args.out:
                        os.makedirs(args.out, exist_ok=True)
                        out_path = os.path.join(args.out,
                                                _tag(arch, shape, mp)
                                                + ".json")
                        if os.path.exists(out_path):
                            print(f"[skip cached] {tag}")
                            with open(out_path) as f:
                                results.append(json.load(f))
                            continue
                    print(f"[dryrun] {tag} ...", flush=True)
                    hlo_path = None
                    if args.out:
                        hlo_dir = os.path.join(args.out, "hlo")
                        os.makedirs(hlo_dir, exist_ok=True)
                        hlo_path = os.path.join(
                            hlo_dir, _tag(arch, shape, mp) + ".trace.json.gz")
                    try:
                        r = run_cell(arch, shape, multi_pod=mp,
                                     save_hlo=hlo_path, device=args.device)
                    except Exception as e:
                        r = {"arch": arch, "shape": shape, "multi_pod": mp,
                             "status": f"FAIL: {type(e).__name__}: {e}",
                             "traceback": traceback.format_exc()}
                        print(r["traceback"], flush=True)
                    results.append(r)
                    status = r["status"]
                    obs.counter("dryrun." + (
                        "ok" if status == "ok" else
                        "skip" if status.startswith("skip") else
                        "fail")).inc()
                    extra = ""
                    if status == "ok":
                        obs.histogram("dryrun.trace_s").record(r["trace_s"])
                        pk = r["memory"]["peak_bytes"]
                        extra = (f" peak={pk / 2**30:.2f}GiB"
                                 f" bound={r['roofline']['bound']}"
                                 f" fits={r['fits']}"
                                 f" trace={r['trace_s']}s")
                    print(f"[done] {tag}: {status}{extra}", flush=True)
                    if out_path:
                        with open(out_path, "w") as f:
                            json.dump(r, f, indent=2)
    finally:
        destroy_world()

    n_ok = sum(1 for r in results if r["status"] == "ok")
    n_skip = sum(1 for r in results if r["status"].startswith("skip"))
    n_fail = len(results) - n_ok - n_skip
    print(f"\n=== dry-run: {n_ok} ok, {n_skip} skip, {n_fail} FAIL "
          f"of {len(results)} cells ===")
    walls = obs.get("dryrun.trace_s")
    if walls is not None and walls.count:
        print(f"walls: trace p50={walls.quantile(0.5):.1f}s "
              f"max={walls.vmax:.1f}s over {walls.count} fresh cells; "
              f"sweep {time.time() - t_sweep:.1f}s")
    if n_fail:
        for r in results:
            if r["status"].startswith("FAIL"):
                print(f"  {r['arch']}/{r['shape']}: {r['status']}")
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
