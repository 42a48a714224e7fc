"""One run of a benchmark cell: build the fleet, time the window, read the
trace, and hold what the timed path produced against the plain reference.

The cell's files are found by name: ``BENCHMARK.json`` gives its
configuration (``configs/<name>.json``) and traffic mix
(``mixes/<name>.json``); the limits of its output check are
``checks/<cell>.json``; each per-layer metric is read by
``metrics/<metric>.py``; the configuration's ``reference`` names its
plain family in ``reference/<family>.py``.

The output check: ``check_tenants`` tenants drawn from the seed are
replayed through every round of the run by the reference from fresh tables
(``replay``), and one more round of every tenant, run after the window, is
stepped by the reference from the states the program left before it
(``one_round``); each compared number is the worse of the two.

``run`` takes the device; ``tgnbench.run`` refuses to start without the
cards a cell asks for, and this module never looks for one.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import re
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from tgnbench import traffic, weights
from tgnbench.reference import common, family

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is in ``FORBIDDEN``, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, overrides: dict | None = None,
              bench: dict | None = None) -> dict:
    """The cell ``name`` of ``bench`` (``BENCHMARK.json`` by default) with
    its configuration, mix, limits and the metrics it reports.
    ``overrides`` (``{"config": {...}, "mix": {...}}``) replaces entries of
    the configuration or the mix."""
    if not NAME.match(name):
        raise ValueError(f"bad workload name {name!r}")
    spec = bench if bench is not None else _json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise ValueError(f"unknown workload {name!r}; cells: {sorted(cells)}")
    wl = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[wl["config"]]
    overrides = overrides or {}
    cfg = {**_json(ROOT / conf["file"]), **overrides.get("config", {})}
    mix = {**_json(HERE / "mixes" / f"{wl['traffic']}.json"),
           **overrides.get("mix", {})}

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {"workload": wl, "config": cfg, "mix": mix,
            "limits": _json(HERE / "checks" / f"{name}.json"),
            "end_to_end": mine(spec["end_to_end"]),
            "per_layer": mine(spec["per_layer"])}


def reader(metric: str):
    """``read(readings) -> float | None`` of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"tgnbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def n_nodes(cfg: dict) -> int:
    return cfg["n_users"] + cfg["n_items"]


def build_program(cfg: dict, mix: dict, params: dict, edge_feats, device):
    """The system under test: a ``SessionManager`` serving ``mix``'s
    tenants on one cohort of ``cfg``'s variant, every slot laid out at
    once (a reserve of exactly the fleet's size, so no admission relays
    the tables out). Returns ``(session, tenant ids)``."""
    from repro_torch.core import pipeline as pl
    from repro_torch.serving.admission import CapacityLadder
    from repro_torch.serving.session import SessionManager

    v = pl.resolve_variant(cfg["variant"])
    if (v.attention, v.encoder, v.prune_k) != (
            cfg["attention"], cfg["encoder"], cfg["prune_k"]):
        raise ValueError(f"variant {cfg['variant']!r} is not the "
                         "configuration's attention, encoder and prune_k")
    model = pl.variant_config(
        cfg["variant"], n_nodes=n_nodes(cfg), n_edges=cfg["n_edges"],
        f_edge=cfg["f_edge"], f_feat=0, f_mem=cfg["f_mem"],
        f_time=cfg["f_time"], f_emb=cfg["f_emb"], m_r=cfg["m_r"],
        n_heads=cfg["n_heads"], lut_entries=cfg["lut_entries"])
    T = mix["tenants"]
    mgr = SessionManager(params, edge_feats, None, model=model,
                         use_kernels=cfg["tier"],
                         reserve=CapacityLadder(classes=(T,)), device=device)
    mgr.prewarm_cohort()
    return mgr, [mgr.add_tenant(name=f"t{i}") for i in range(T)]


def busy_s(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def device_timeline(prof) -> SimpleNamespace:
    """The device's side of a profiler window: every device operation as
    (name, start s, end s), the busy time (union of their intervals), the
    ten operations that took most time, and the ten longest gaps between
    device work, each named by the innermost host operation running when
    it began."""
    dev, host = [], []
    for e in prof.events():
        iv = (e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append(iv)
        else:
            host.append(iv)
    by_name: dict = {}
    for name, s, e in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps, end = [], None
    for _, s, e in sorted(dev, key=lambda x: x[1]):
        if end is not None and s > end:
            gaps.append((end, s - end))
        end = e if end is None else max(end, e)
    gaps = sorted(gaps, key=lambda g: -g[1])[:10]

    def label(t):
        inner = [(e - s, n) for n, s, e in host if s <= t < e]
        return min(inner)[1] if inner else "(Python between ops)"

    return SimpleNamespace(
        events=dev, busy_s=busy_s((s, e) for _, s, e in dev),
        device_ops=[[n[:120], v] for n, v in top],
        idle_gaps=[[label(t)[:120], v] for t, v in gaps])


class _Window:
    """Drives closed-loop rounds: round r + 1 is issued after round r's
    synchronize. Keeps each round's latency (the call to ``step`` to the
    synchronize after it) and host issue time (the call alone), and copies
    the checked tenants' embeddings of the checked rounds aside."""

    def __init__(self, mgr, tids, feed: traffic.Replay, device, checked,
                 sample, buf: torch.Tensor):
        self.mgr, self.tids, self.feed, self.buf = mgr, tids, feed, buf
        self.device = device
        self.valid = np.ones((feed.B,), dtype=bool)
        self.checked = [tids[i] for i in checked]
        self.sample = sample            # round -> buffer slot or None
        self.round = 0
        self.failed = 0
        self.error = None

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self, keep: list | None = None,
             hold: bool = False) -> float | None:
        """One round; returns the host clock after its synchronize, or
        None when it raised. ``hold`` keeps every tenant's embeddings of
        the round as ``self.held`` (T, 2, B, f_emb)."""
        src, dst, eid, ts = self.feed.batch(self.round)
        batches = {tid: (src[i], dst[i], eid[i], ts[i], self.valid)
                   for i, tid in enumerate(self.tids)}
        try:
            t0 = time.perf_counter()
            outs = self.mgr.step(batches)
            t1 = time.perf_counter()
            self.sync()
            t2 = time.perf_counter()
        except Exception:
            self.failed += 1
            self.error = traceback.format_exc()
            return None
        if keep is not None:
            keep.append((t2 - t0, t1 - t0))
        if hold:
            self.held = torch.stack([torch.stack([outs[t].emb_src,
                                                  outs[t].emb_dst])
                                     for t in self.tids])
        slot = self.sample(self.round)
        if slot is not None:
            for j, tid in enumerate(self.checked):
                self.buf[slot, j, 0].copy_(outs[tid].emb_src)
                self.buf[slot, j, 1].copy_(outs[tid].emb_dst)
        self.round += 1
        return t2


#: the state's fields compared by magnitude, then exactly, as (program's
#: ``VertexState`` name, reference's ``Tables`` name)
CLOSE = (("memory", "memory"), ("mail", "mail"))
EXACT = (("last_update", "last_update"), ("mail_ts", "mail_ts"),
         ("mail_valid", "mail_valid"), ("nbr_ids", "nbr_ids"),
         ("nbr_ts", "nbr_ts"), ("nbr_eid", "nbr_eid"),
         ("nbr_cursor", "cursor"))


def compare(got_emb, got_state: list, want) -> dict:
    """The compared numbers: ``emb_err`` and ``state_err``, the largest gap
    of an embedding of a compared round and of the final memory and mail,
    each over the largest magnitude of the reference's; and
    ``state_mismatch``, the entries of the final timestamps, mail flags,
    rings and cursors that differ. ``want`` is the reference's
    (embeddings, tables), as ``replay`` or ``one_round`` gives them;
    ``got_state`` the compared tenants' states, in the tables' order."""
    want_emb, tab = want
    err = float("nan")          # no sampled round: not correct
    if got_emb.shape[0]:
        err = float((got_emb - want_emb).abs().max() / want_emb.abs().max())
    state_err, mismatch = 0.0, 0
    n = sum(st.memory.shape[0] for st in got_state)
    for fields, exact in ((CLOSE, False), (EXACT, True)):
        for name, ref_name in fields:
            got = torch.cat([getattr(st, name) for st in got_state])
            ref = getattr(tab, ref_name)[:n]
            if exact:
                mismatch += int((got.to(ref.dtype) != ref).sum())
            else:
                state_err = max(state_err, float(
                    (got - ref).abs().max() / ref.abs().max()))
    return {"emb_err": err, "state_err": state_err,
            "state_mismatch": mismatch}


def reference_model(cfg: dict, seed: int, device,
                    precision: str = "fp32"):
    """The reference's family and its prepared weights, drawn again from
    the seed: ``(family module, prep)``."""
    fam = family(cfg["reference"])
    params = weights.init(cfg, traffic.seed32(seed, 1), device)
    return fam, fam.prepare(params, cfg, precision)


def _worst(x) -> float:
    """Orders compared numbers with NaN (no reading) above every other."""
    return float("inf") if x != x else x


def replay(cfg: dict, model, g: traffic.Graph, feed: traffic.Replay,
           rounds: int, checked, sampled: dict, device,
           precision: str = "fp32"):
    """The checked tenants' ``rounds`` rounds through the reference
    ``model`` (``reference_model``'s) from fresh tables. Returns
    (embeddings of the sampled rounds (slots, S, 2, B, f_emb), tables)."""
    fam, prep = model
    S = len(checked)
    tab = common.init_tables(S * n_nodes(cfg), cfg["f_mem"], cfg["f_edge"],
                             cfg["m_r"], device)
    ef = torch.from_numpy(g.edge_feats).to(device)
    embs = torch.zeros((max(len(sampled), 1), S, 2, feed.B, cfg["f_emb"]),
                       device=device)
    chunk = 256
    for lo in range(0, rounds, chunk):
        hi = min(lo + chunk, rounds)
        parts = [feed.batch(r, checked) for r in range(lo, hi)]
        dev = [torch.from_numpy(np.stack(x)).to(device)
               for x in zip(*parts)]
        for r in range(lo, hi):
            h = common.step(fam, prep, tab, [x[r - lo] for x in dev], ef,
                            n_nodes(cfg), precision)
            if r in sampled:
                embs[sampled[r]] = h
    return embs, tab


def one_round(cfg: dict, model, g: traffic.Graph, feed: traffic.Replay,
              r: int, states: list, device):
    """Round ``r`` of every tenant through the reference ``model``, from
    the tenants' states before it as the program left them (``states``,
    one ``VertexState`` a tenant, in tenant order). Returns (embeddings
    (T, 2, B, f_emb), tables)."""
    fam, prep = model
    fields = dict((ref, prog) for prog, ref in CLOSE + EXACT)
    spare = common.init_tables(0, cfg["f_mem"], cfg["f_edge"], cfg["m_r"],
                               device)
    tab = common.Tables(*(
        torch.cat([getattr(st, fields[name]).to(want.dtype) for st in states]
                  + [want])
        for name, want in zip(common.Tables._fields, spare)))
    batch = [torch.from_numpy(x).to(device) for x in feed.batch(r)]
    ef = torch.from_numpy(g.edge_feats).to(device)
    h = common.step(fam, prep, tab, batch, ef, n_nodes(cfg))
    return h, tab


def stream(cfg: dict, mix: dict, seed: int):
    """The configuration's stream and the mix's replay of it for
    ``seed``: ``(graph, Replay)``."""
    g = traffic.generate(cfg["n_users"], cfg["n_items"], cfg["n_edges"],
                         cfg["f_edge"], cfg["stream_seed"])
    return g, traffic.Replay(g, mix["tenants"], mix["batch"],
                             shift=traffic.seed32(seed, 0) % cfg["n_edges"])


def plan(mix: dict, seed: int):
    """The tenants and rounds the output check compares, from the seed:
    ``check_tenants`` tenants, and every ``check_stride``-th round after
    the warm-up from a seeded phase on, ``check_rounds`` at most. Returns
    (tenant indices, ``sample(r)``: the buffer slot of round r or None,
    and the dict of sampled rounds it fills)."""
    pick = np.random.default_rng(traffic.seed32(seed, 2))
    T = mix["tenants"]
    checked = sorted(int(i) for i in pick.choice(
        T, size=min(mix["check_tenants"], T), replace=False))
    stride, cap = mix["check_stride"], mix["check_rounds"]
    phase = int(pick.integers(stride))
    warm = mix["warmup_rounds"]
    sampled: dict = {}

    def sample(r):
        if r >= warm and (r - warm) % stride == phase and len(sampled) < cap:
            sampled[r] = len(sampled)
            return sampled[r]
        return None

    return checked, sample, sampled


def _views(tab: common.Tables, S: int, V: int) -> list:
    """A reference's tables as the S tenants' states, under the names of
    the program's ``VertexState``."""
    return [SimpleNamespace(**{k: getattr(tab, v)[s * V:(s + 1) * V]
                               for k, v in CLOSE + EXACT}) for s in range(S)]


def control(workload: str, seed: int, rounds: int, device, *,
            overrides: dict | None = None, bench: dict | None = None) -> dict:
    """The output check's control: the reference computed with its
    products in TF32 (the precision below the configuration's fp32) put
    in the program's place for ``rounds`` rounds, and compared as a run
    compares the program."""
    device = torch.device(device)
    cell = load_cell(workload, overrides, bench)
    cfg, mix = cell["config"], cell["mix"]
    g, feed = stream(cfg, mix, seed)
    checked, sample, sampled = plan(mix, seed)
    for r in range(rounds):
        sample(r)
    want = replay(cfg, reference_model(cfg, seed, device), g, feed, rounds,
                  checked, sampled, device)
    emb, tab = replay(cfg, reference_model(cfg, seed, device, "tf32"), g,
                      feed, rounds, checked, sampled, device, "tf32")
    return compare(emb, _views(tab, len(checked), n_nodes(cfg)), want)


def run(workload: str, seed: int, seconds: float, trace: bool, device, *,
        t_start: float, overrides: dict | None = None,
        bench: dict | None = None) -> dict:
    """One run of cell ``workload``: the result line's fields (``checks``
    last), then under ``_notes`` the JAX modules loaded once the window
    closed (``forbidden_modules``), the rounds run and checked, the
    reference's seconds and the traceback of a round that raised."""
    device = torch.device(device)
    cell = load_cell(workload, overrides, bench)
    cfg, mix = cell["config"], cell["mix"]
    T, B = mix["tenants"], mix["batch"]
    g, feed = stream(cfg, mix, seed)
    params = weights.init(cfg, traffic.seed32(seed, 1), device)
    mgr, tids = build_program(cfg, mix, params, g.edge_feats, device)
    del params

    checked, sample, sampled = plan(mix, seed)
    warm, cap, S = mix["warmup_rounds"], mix["check_rounds"], len(checked)
    win = _Window(mgr, tids, feed, device, checked, sample,
                  torch.zeros((cap, S, 2, B, cfg["f_emb"]), device=device))
    for _ in range(warm):
        if win.step() is None:
            break

    # the measured window
    timed: list = []
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    end = t0
    while win.failed == 0:
        t = win.step(timed)
        if t is None:
            break
        end = t
        if end - t0 >= seconds:
            break
    window_s = end - t0

    readings = None
    if trace and win.failed == 0:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            p0 = time.perf_counter()
            for _ in range(mix["trace_rounds"]):
                if win.step() is None:
                    break
            traced_s = time.perf_counter() - p0
        tl = device_timeline(prof)
        del prof
    if trace and win.failed == 0:
        readings = SimpleNamespace(
            cfg=cfg, mix=mix, tenants=T, rows=T * 2 * B,
            round_wall_s=[lat for lat, _ in timed],
            issue_s=[iss for _, iss in timed],
            traced_rounds=mix["trace_rounds"], traced_s=traced_s,
            events=tl.events, busy_s=tl.busy_s, device_ops=tl.device_ops,
            idle_gaps=tl.idle_gaps)

    forbidden = forbidden_modules()     # once the window has closed
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    # one more round of the same call, every tenant's embeddings and
    # states kept, with the states before it
    last = win.round
    before = [mgr.state_of(t) for t in tids] if win.failed == 0 else None
    if before is not None and win.step(hold=True) is not None:
        after = [mgr.state_of(t) for t in tids]
        got_last = win.held
    rounds, failed, error = win.round, win.failed, win.error
    got_emb = win.buf[:len(sampled)]
    del mgr, win
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    limits = cell["limits"]
    check_s = None
    if failed:
        numbers = dict.fromkeys(limits)
        correct = False
    else:
        c0 = time.perf_counter()
        model = reference_model(cfg, seed, device)
        whole = compare(got_emb, [after[i] for i in checked], replay(
            cfg, model, g, feed, rounds, checked, sampled, device))
        del got_emb
        once = compare(got_last, after, one_round(
            cfg, model, g, feed, last, before, device))
        del before, after, got_last
        numbers = {k: max(whole[k], once[k], key=_worst) for k in whole}
        check_s = time.perf_counter() - c0
        correct = all(numbers[k] <= limits[k] for k in limits)

    metrics = {}
    if not trace:
        lat = [x for x, _ in timed]
        vals = {"edges_per_s": len(timed) * T * B / window_s,
                "round_p95_ms": float(np.percentile(lat, 95)) * 1e3,
                "setup_s": setup_s} if timed else {}
        for m in cell["end_to_end"]:
            if m["name"] in vals:
                metrics[m["name"]] = {"value": vals[m["name"]],
                                      "unit": m["unit"]}
    elif readings is not None:
        for m in cell["per_layer"]:
            v = reader(m["name"])(readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": len(timed) + failed,
           "failed": failed, "metrics": metrics, "device": dev}
    if readings is not None:
        dev["busy_s"] = readings.busy_s
        dev["window_s"] = readings.traced_s
        out["breakdown"] = {"device_ops": readings.device_ops,
                            "idle_gaps": readings.idle_gaps}
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                     for k in limits}
    out["_notes"] = {"forbidden": forbidden, "rounds": rounds,
                     "window_rounds": len(timed),
                     "checked_rounds": len(sampled), "check_s": check_s,
                     "error": error}
    return out
