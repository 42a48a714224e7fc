"""Serving entry point: stream a synthetic temporal graph through the port
and report latency/throughput, or generate with a language model.

Port of ``repro.launch.serve``: ``--mode tgn`` (the default) and ``--mode
lm``. In ``--mode tgn`` one stream is served by the StreamingEngine, in
batches of ``--batch`` edges or, with ``--window-s``, in windows of that
many seconds of stream time (at most ``--batch`` edges each). With
``--tenants N`` (or ``--tenant-variants``) the stream is split into N
contiguous feeds, one a tenant, served by the multi-tenant
SessionManager: each round issues every
cohort's step in one call, each kernel launched once a cohort over all its
tenants' rows (``--per-cohort``: one launch a cohort, the baseline).
``--tenant-params`` puts tenants on named parameter sets (a name maps to
weights drawn from a seed derived from it; the teacher lane needs one).
Runs on the GPU unless ``--device cpu`` is given.

The serving stack (each flag puts the run on the session):
``--snapshot-dir`` snapshots every tenant (atomic, crc-checked) every
``--snapshot-every`` rounds and at exit, and ``--restore`` resumes the
tenants found there; ``--journal-dir`` journals every event before it is
queued (restores then replay the journal: lossless); ``--guard`` arms the
``FleetGuard`` (finite-state sentinel, quarantine, restore with backoff,
``--max-restores``, ``--quarantine-slo-burn``); ``--slo-ms`` tracks SLO
burn a tenant, ``--metrics-every`` prints the metrics registry, and
``--trace-out`` writes a sampled round trace (Chrome JSON, or JSONL).
``--listen HOST:PORT`` serves the online front end instead of replaying
the stream: NDJSON requests (ingest, attach, detach, stats, metrics,
flush), batched under ``--deadline-ms`` / ``--max-rows``.

``--mesh`` serves the fleet on the sharded tenant fabric
(``serving/cluster.py``): ``"tenant=4,vertex=2"``, ``"8"``, or ``""`` for
every visible card on the tenant axis. On the GPU the mesh takes the
visible cards and raises when there are too few; with ``--device cpu``
it takes that many repeats of the CPU. ``--restore`` resumes snapshots
onto any mesh shape.

``--mode lm`` is the reference's LM serve path: ``--arch``'s smoke config
(random weights from a seed) generates ``--new-tokens`` tokens after
``--batch`` prompts of 8 tokens, greedy unless ``--temperature`` > 0, and
prints the shape and the prefill and decode times.

Examples:
    PYTHONPATH=src python -m repro_torch.launch.serve --kernels fused
    PYTHONPATH=src python -m repro_torch.launch.serve --kernels ref \\
        --edges 800 --batch 100 --f-mem 16 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --dataset gdelt
    PYTHONPATH=src python -m repro_torch.launch.serve --window-s 900 \
        --batch 256 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --variant teacher \\
        --edges 800 --batch 100 --f-mem 16 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --tenants 4 \\
        --kernels fused
    PYTHONPATH=src python -m repro_torch.launch.serve --kernels fused \\
        --tenant-variants sat+lut+np4,sat+lut+np4+reservoir,teacher \\
        --tenant-params ,,teacher-v1
    PYTHONPATH=src python -m repro_torch.launch.serve --tenants 3 \\
        --kernels fused --guard --journal-dir /tmp/wal \\
        --snapshot-dir /tmp/snaps --snapshot-every 5 --slo-ms 25
    PYTHONPATH=src python -m repro_torch.launch.serve --tenants 3 \\
        --listen 127.0.0.1:0 --serve-seconds 10 --guard --journal-dir /tmp/wal
    PYTHONPATH=src python -m repro_torch.launch.serve --tenants 5 \\
        --mesh tenant=2,vertex=2 --edges 800 --batch 100 --f-mem 16 \\
        --device cpu

    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \\
        --arch qwen3_8b --batch 4 --device cpu

``--variant`` takes any registry name or alias of
``repro_torch.core.pipeline`` (``teacher``, ``"+SAT"``, ``"+NP(S)"``,
``reservoir``, ...). ``--dataset gdelt`` serves static node features
(f_feat = 200) and no edge features. A fused request outside the fused
step's coverage (static node features, the cosine variants) runs the
staged tier, as in the reference, and the printed stages say so.
"""
from __future__ import annotations

import argparse
import json
import math
import zlib

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import tgn
from repro_torch.core.pipeline import variant_config
from repro_torch.data import stream, temporal_graph as tgd
from repro_torch.distributed import tgn_sharding as tsh
from repro_torch.models import lm_common
from repro_torch.serving import lm_serve
from repro_torch.serving.cluster import ShardedSessionManager
from repro_torch.serving.engine import EngineConfig, StreamingEngine
from repro_torch.serving.session import DEFAULT_PARAMS, SessionManager
from repro_torch.utils import resolve_device


def _tenant_variants(args) -> list:
    return ([v for v in args.tenant_variants.split(",") if v]
            if args.tenant_variants else [args.variant] * args.tenants)


def _tenant_params(args, n: int) -> list:
    """--tenant-params names aligned with the tenant list, padded with the
    default set (an empty entry means the default too)."""
    names = ([p.strip() for p in args.tenant_params.split(",")]
             if args.tenant_params else [])
    if len(names) > n:
        raise SystemExit(f"--tenant-params lists {len(names)} sets for "
                         f"{n} tenants")
    names += [""] * (n - len(names))
    return [p or DEFAULT_PARAMS for p in names]


def _ensure_param_sets(mgr, variants, pnames) -> None:
    """Register every named set the fleet asks for: the CLI has no weight
    files, so a name maps to weights for that tenant's variant drawn from
    a seed derived from the name (the same name, the same weights)."""
    for v, pname in zip(variants, pnames):
        if pname == DEFAULT_PARAMS or pname in mgr.param_store:
            continue
        cfg = mgr._tenant_cfg(v, None, pname)
        seed = zlib.crc32(pname.encode())
        mgr.register_params(pname, tgn.init_params(
            torch.Generator().manual_seed(seed), cfg, mgr.device))
        print(f"registered param set {pname!r} "
              f"(digest {mgr.param_store.digest(pname)}, seed {seed})")


class _SnapshotHooks:
    """--snapshot-dir: periodic snapshots through a background writer
    (``cluster.TenantSnapshotWriter``; a tenant whose last write is still
    running is skipped that time), a synchronous snapshot of every tenant
    at exit, and --restore. With a journal each manifest records the
    tenant's replay cursor, a restore replays the journal after it, and
    the exit truncates the journal up to the oldest kept snapshot."""

    def __init__(self, mgr, args, journal=None):
        from repro_torch.serving import cluster
        self.cluster = cluster
        self.mgr = mgr
        self.root = args.snapshot_dir
        self.do_restore = args.restore
        self.available = cluster.list_snapshots(self.root)
        self.base_step = {}          # tid -> step its trajectory resumed at
        self.writer = cluster.TenantSnapshotWriter(self.root)
        self.journal = journal
        self.floor = {}              # tid -> the journal's anchor step

    def _meta(self, tid):
        if self.journal is None:
            return None
        return {"journal": self.journal.cursor(tid)}

    def restore(self, variant, name):
        """Revive ``name`` from disk (--restore, a snapshot exists): its
        id, else None (the caller adds it fresh)."""
        from repro_torch.core import pipeline
        if not (self.do_restore and name in self.available):
            return None
        meta = self.cluster.snapshot_meta(self.root, name)
        want = pipeline.variant_name(pipeline.resolve_variant(variant))
        if want != meta["variant"]:
            raise ValueError(
                f"tenant {name!r} was snapshotted as {meta['variant']!r} "
                f"but this run requests {want!r} — a restored trajectory "
                "keeps its policy; drop the conflicting "
                "--variant/--tenant-variants entry or point --snapshot-dir "
                "at a fresh directory")
        tid = self.cluster.restore_tenant(self.mgr, self.root, name,
                                          journal=self.journal)
        base, replayed = self.available[name], 0
        if self.journal is not None \
                and self.journal.last_replay is not None:
            replayed = self.journal.last_replay.rounds
            base += replayed
        self.base_step[tid] = base
        print(f"restored tenant {tid!r} ({meta['variant']}) from "
              f"{self.root} step {self.available[name]}"
              + (f" + {replayed} journal round(s)" if replayed else ""))
        return tid

    def save(self, rounds):
        # a quarantined tenant's state is suspect: never snapshot it
        for tid in self.mgr.tenants:
            if self.mgr.is_quarantined(tid):
                continue
            self.writer.submit(self.mgr, tid,
                               step=self.base_step.get(tid, 0) + rounds,
                               extra_meta=self._meta(tid),
                               keep_floor=self.floor.get(tid))

    def save_final(self, rounds):
        # the writer drains first; its failure must not stop the exit save
        try:
            self.writer.close()
        except Exception as e:
            print(f"snapshot writer: {e}; writing the exit snapshots "
                  "synchronously anyway")
        for tid in self.mgr.tenants:
            self.cluster.snapshot_tenant(
                self.mgr, tid, self.root,
                step=self.base_step.get(tid, 0) + rounds,
                extra_meta=self._meta(tid),
                keep_floor=self.floor.get(tid))
            if self.journal is not None:
                anchor = self.cluster.truncate_journal(
                    self.journal, self.root, tid)
                if anchor is not None:
                    self.floor[tid] = anchor
        if self.writer.skipped:
            print(f"snapshot writer: {self.writer.skipped} periodic "
                  "save(s) skipped while a previous write was in flight")


def _make_guard(mgr, args, writer=None, journal=None):
    """--guard: the ``FleetGuard`` (every round then goes through it)."""
    if not args.guard:
        return None
    from repro_torch.serving.guard import FleetGuard
    return FleetGuard(mgr, snapshot_root=args.snapshot_dir, writer=writer,
                      max_restores=args.max_restores,
                      quarantine_slo_burn=args.quarantine_slo_burn,
                      journal=journal)


def _make_journal(args):
    """--journal-dir: the write-ahead ``EventJournal``."""
    if not args.journal_dir:
        return None
    from repro_torch.serving.journal import EventJournal
    return EventJournal(args.journal_dir,
                        fsync_s=args.journal_fsync_ms / 1e3,
                        dedup_window=args.dedup_window)


def _make_tracer(args):
    """--trace-out: the sampled ``RoundTracer``."""
    if not args.trace_out:
        return None
    from repro_torch.obs import RoundTracer
    return RoundTracer(sample_every=args.trace_every)


def _export_trace(tracer, args):
    """Write the spans at exit: Chrome/Perfetto JSON, or JSONL when the
    path ends in .jsonl."""
    if tracer is None:
        return
    if args.trace_out.endswith(".jsonl"):
        tracer.write_jsonl(args.trace_out)
    else:
        tracer.write_chrome(args.trace_out)
    print(f"trace: {tracer.summary()} -> {args.trace_out}")


def _print_metrics(obs, tag=""):
    print(f"metrics{tag}:",
          json.dumps(obs.snapshot(), sort_keys=True, default=float),
          flush=True)


def _add_tenants(mgr, args, snapshots=None) -> list:
    variants = _tenant_variants(args)
    pnames = _tenant_params(args, len(variants))
    _ensure_param_sets(mgr, variants, pnames)
    tids = []
    for i, (v, p) in enumerate(zip(variants, pnames)):
        tid = snapshots.restore(v, f"t{i}") if snapshots else None
        tids.append(tid if tid is not None else
                    mgr.add_tenant(v, name=f"t{i}", params=p))
    return tids


def run_frontend(args, g, cfg, params, device) -> dict:
    """--listen: the online front end. A reserve-enabled session (live
    attach and detach land in spare slots) behind ``ServingFrontend``,
    serving NDJSON on the given address."""
    import asyncio

    from repro_torch.serving.admission import CapacityLadder
    from repro_torch.serving.frontend import (FrontendConfig,
                                              ServingFrontend, serve_jsonl)

    mgr = SessionManager(params, g.edge_feats, g.node_feats, model=cfg,
                         use_kernels=args.kernels, reserve=CapacityLadder(),
                         device=device)
    _add_tenants(mgr, args)
    fcfg = FrontendConfig(max_wait_s=args.deadline_ms / 1e3,
                          max_rows=args.max_rows, queue_rows=args.queue_rows,
                          pad_quantum=args.pad_quantum)
    tracer = _make_tracer(args)
    journal = _make_journal(args)
    fe = ServingFrontend(mgr, fcfg, tracer=tracer,
                         slo_ms=args.slo_ms or None,
                         slo_objective=args.slo_objective, journal=journal)
    guard = _make_guard(mgr, args, journal=journal)
    host, _, port = args.listen.partition(":")

    async def serve():
        await fe.start()
        server = await serve_jsonl(fe, host or "127.0.0.1", int(port or 0))
        addr = server.sockets[0].getsockname()
        print(f"serving JSON-lines on {addr[0]}:{addr[1]} "
              f"(deadline {fcfg.max_wait_s * 1e3:.1f}ms, "
              f"max-rows {fcfg.max_rows}, tenants {list(mgr.tenants)})",
              flush=True)
        ticker = None
        if args.metrics_every:
            async def tick():
                # online, --metrics-every is in seconds
                while True:
                    await asyncio.sleep(args.metrics_every)
                    _print_metrics(fe.obs)
            ticker = asyncio.create_task(tick())
        try:
            if args.serve_seconds > 0:
                await asyncio.sleep(args.serve_seconds)
            else:
                await asyncio.Event().wait()      # until interrupted
        finally:
            if ticker is not None:
                ticker.cancel()
            server.close()
            await server.wait_closed()
            await fe.stop()

    try:
        asyncio.run(serve())
    except KeyboardInterrupt:
        pass
    if journal is not None:
        journal.close()
    stats = fe.stats()
    print("frontend stats:", stats)
    if args.slo_ms:
        print("slo:", {tid: mgr.slo.tenant(tid) for tid in mgr.tenants})
    if guard is not None:
        print("guard:", guard.snapshot())
    _export_trace(tracer, args)
    return stats


def _fabric_mesh(spec, device):
    """The ``--mesh`` mesh: the visible cards, or repeats of the CPU."""
    if device.type == "cuda":
        return tsh.make_tenant_mesh(spec)
    n = math.prod(tsh.mesh_sizes(spec, 1).values())
    return tsh.make_tenant_mesh(spec, devices=[device] * n)


def run_fleet(args, g, cfg, params, device) -> dict:
    """The stream split into one contiguous feed a tenant, served by one
    session (on the ``--mesh`` fabric when given), with the serving
    stack's flags."""
    kw = dict(model=cfg, use_kernels=args.kernels,
              coalesce=not args.per_cohort)
    if args.mesh is not None:
        mgr = ShardedSessionManager(params, g.edge_feats, g.node_feats,
                                    mesh=_fabric_mesh(args.mesh, device),
                                    **kw)
    else:
        mgr = SessionManager(params, g.edge_feats, g.node_feats,
                             device=device, **kw)
    tracer = _make_tracer(args)
    if tracer is not None:
        mgr.set_tracer(tracer)
    if args.slo_ms:
        mgr.set_slo(args.slo_ms, args.slo_objective)
    journal = _make_journal(args)
    snapshots = (_SnapshotHooks(mgr, args, journal=journal)
                 if args.snapshot_dir else None)
    guard = _make_guard(mgr, args,
                        writer=snapshots.writer if snapshots else None,
                        journal=journal)
    tids = _add_tenants(mgr, args, snapshots)
    print("session cohorts:", {k: (c["tenants"], c["tier"])
                               for k, c in mgr.describe().items()
                               if "tenants" in c})
    if args.mesh is not None:
        print("fabric mesh:", mgr.mesh.shape)
    span = g.n_edges // len(tids)
    streams = {}
    for i, tid in enumerate(tids):
        lo = i * span
        if snapshots:
            # a restored tenant resumes its window where its snapshot
            # left off (a round is one --batch of edges)
            lo += min(snapshots.base_step.get(tid, 0) * args.batch, span)
        streams[tid] = stream.fixed_count(g, args.batch,
                                          window=slice(lo, (i + 1) * span))
    if journal is not None:
        # write-ahead: a batch is journaled (its host columns) as it is
        # pulled, before the round that applies it
        def journaled(tid, it):
            for b in it:
                journal.append_batch(tid, b)
                yield b
        streams = {t: journaled(t, s) for t, s in streams.items()}
    rounds = 0
    for _batches, _outs in mgr.run(streams):
        rounds += 1
        if snapshots and args.snapshot_every \
                and rounds % args.snapshot_every == 0:
            snapshots.save(rounds)
        if args.metrics_every and rounds % args.metrics_every == 0:
            _print_metrics(mgr.obs, tag=f" (round {rounds})")
    if snapshots:
        snapshots.save_final(rounds)
        steps = {t: snapshots.base_step.get(t, 0) + rounds
                 for t in sorted(mgr.tenants)}
        print(f"snapshots: {steps} -> {args.snapshot_dir}")
    if journal is not None:
        jstats = journal.stats()
        journal.close()
        print("journal:", jstats, "->", args.journal_dir)
    summary = mgr.summary()
    print("session summary:", summary)
    if guard is not None:
        print("guard:", guard.snapshot())
    _export_trace(tracer, args)
    return summary


def run_tgn(args) -> dict:
    device = resolve_device(args.device)
    g = tgd.DATASETS[args.dataset](n_edges=args.edges)
    cfg = variant_config(
        args.variant, n_nodes=g.cfg.n_nodes, n_edges=g.n_edges,
        f_edge=g.cfg.f_edge, f_feat=g.cfg.f_feat, f_mem=args.f_mem,
        f_time=args.f_mem, f_emb=args.f_mem, m_r=10)
    params = tgn.init_params(torch.Generator().manual_seed(0), cfg, device)
    if args.listen is not None:
        return run_frontend(args, g, cfg, params, device)
    if (args.tenant_variants or args.tenants > 1 or args.snapshot_dir
            or args.slo_ms or args.trace_out or args.guard
            or args.journal_dir or args.mesh is not None):
        return run_fleet(args, g, cfg, params, device)
    engine = StreamingEngine(EngineConfig(model=cfg, use_kernels=args.kernels),
                             params, g.edge_feats, g.node_feats,
                             device=device)
    print("engine stages:", engine.describe())
    if args.window_s:
        batches = stream.time_window(g, args.window_s, args.batch)
    else:
        batches = stream.fixed_count(g, args.batch)
    for _batch, _out in engine.run(batches):
        pass
    summary = engine.summary()
    print("engine summary:", summary)
    return summary


def run_lm(args) -> dict:
    """``--mode lm``: the reference's LM serve path. An ``--arch``'s smoke
    config with seeded random weights generates ``--new-tokens`` after
    ``--batch`` prompts of 8 tokens (``RandomState(0)``), greedy unless
    ``--temperature`` > 0."""
    device = resolve_device(args.device)
    cfg = configs.get(args.arch).smoke_config()
    params = lm_common.init_params(torch.Generator().manual_seed(0), cfg,
                                   device)
    prompts = torch.as_tensor(
        np.random.RandomState(0).randint(0, cfg.vocab, size=(args.batch, 8)),
        dtype=torch.int32, device=device)
    out = lm_serve.generate(params, cfg, prompts,
                            lm_serve.ServeConfig(
                                max_new_tokens=args.new_tokens,
                                temperature=args.temperature))
    print(f"generated {tuple(out['tokens'].shape)}; "
          f"prefill {out['prefill_s']*1e3:.1f}ms, "
          f"decode {out['decode_s_per_tok']*1e3:.2f}ms/token")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("tgn", "lm"), default="tgn",
                    help="serve the temporal GNN's edge stream (tgn) or "
                         "generate with a registered language model (lm)")
    ap.add_argument("--dataset", default="wikipedia",
                    choices=tuple(tgd.DATASETS))
    ap.add_argument("--edges", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=200)
    ap.add_argument("--window-s", type=float, default=0.0,
                    help="tgn: serve every edge of consecutive windows of "
                    "this many seconds of stream time, at most --batch a "
                    "window (0: batches of exactly --batch edges)")
    ap.add_argument("--f-mem", type=int, default=32)
    ap.add_argument("--variant", default="sat+lut+np4",
                    help="a registry name or alias: vanilla+cosine "
                         "(teacher), sat+cosine (+SAT), sat+lut (+LUT), "
                         "sat+lut+np<k> (+NP(L/M/S), student), "
                         "sat+lut+np4+uniform, sat+lut+np4+reservoir, or "
                         "the grammar <attention>+<encoder>[+np<k>]"
                         "[+<sampler>]")
    ap.add_argument("--kernels", default="staged",
                    choices=("ref", "staged", "fused"),
                    help="kernel tier: torch references, one CUDA kernel "
                         "per unit, or the fused single-pass step")
    ap.add_argument("--tenants", type=int, default=1,
                    help="serve N tenants, each a contiguous window of the "
                         "stream, through one SessionManager")
    ap.add_argument("--tenant-variants", default="",
                    help="comma-separated variant a tenant (overrides "
                         "--tenants/--variant); a variant other than the "
                         "session's attention+encoder needs a named set in "
                         "--tenant-params")
    ap.add_argument("--tenant-params", default="",
                    help="comma-separated parameter-set name a tenant "
                         "(empty: the default set)")
    ap.add_argument("--per-cohort", action="store_true",
                    help="one launch a cohort instead of the coalesced "
                         "round (the baseline)")
    ap.add_argument("--mesh", default=None,
                    help="serve the fleet on the sharded tenant fabric: a "
                         "mesh spec like '8' or 'tenant=4,vertex=2' ('' "
                         "= every card on the tenant axis); too few "
                         "devices raise")
    ap.add_argument("--snapshot-dir", default=None,
                    help="snapshot every tenant's state here (atomic, "
                         "crc32-checked)")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="also snapshot every N rounds (0: only at exit)")
    ap.add_argument("--restore", action="store_true",
                    help="resume the tenants found in --snapshot-dir")
    ap.add_argument("--listen", default=None, metavar="HOST:PORT",
                    help="serve the online NDJSON front end instead of "
                         "replaying the stream (port 0: any free port)")
    ap.add_argument("--deadline-ms", type=float, default=10.0,
                    help="front end: a round flushes when its oldest "
                         "queued event is this old")
    ap.add_argument("--max-rows", type=int, default=128,
                    help="front end: a round flushes when a tenant has "
                         "this many events queued")
    ap.add_argument("--queue-rows", type=int, default=1024,
                    help="front end: queued events a tenant; beyond it an "
                         "ingest gets retry_after")
    ap.add_argument("--pad-quantum", type=int, default=32,
                    help="front end: pad flushed batches to a multiple of "
                         "this (0: exact widths)")
    ap.add_argument("--serve-seconds", type=float, default=0.0,
                    help="with --listen: serve this long, then exit (0: "
                         "until interrupted)")
    ap.add_argument("--slo-ms", type=float, default=0.0,
                    help="SLO target a tenant: round wall offline, event "
                         "latency with --listen (0: off)")
    ap.add_argument("--slo-objective", type=float, default=0.99,
                    help="the SLO's objective, e.g. 0.99: p99 under "
                         "--slo-ms")
    ap.add_argument("--metrics-every", type=int, default=0,
                    help="print the metrics registry every N rounds "
                         "(offline) or seconds (--listen); 0: never")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the sampled round trace here at exit: "
                         "Chrome/Perfetto JSON, or JSONL for a .jsonl path")
    ap.add_argument("--trace-every", type=int, default=8,
                    help="trace 1 round in N (a traced round waits for "
                         "the device)")
    ap.add_argument("--guard", action="store_true",
                    help="arm the FleetGuard: finite-state checks, "
                         "quarantine, restore (from --snapshot-dir), tier "
                         "degradation on an injected kernel fault")
    ap.add_argument("--max-restores", type=int, default=3,
                    help="evict a quarantined tenant after this many "
                         "failed restores")
    ap.add_argument("--quarantine-slo-burn", type=float, default=0.0,
                    help="quarantine a tenant whose SLO burn rate passes "
                         "this (needs --guard and --slo-ms; 0: off)")
    ap.add_argument("--journal-dir", default=None,
                    help="journal every accepted event here before it is "
                         "queued; (client_id, seq) retries dedup, restores "
                         "replay the journal")
    ap.add_argument("--journal-fsync-ms", type=float, default=5.0,
                    help="fsync the journal at most this often (0: every "
                         "append)")
    ap.add_argument("--dedup-window", type=int, default=1024,
                    help="per-client window of seqs remembered for "
                         "dedup")
    ap.add_argument("--arch", default="qwen3_8b",
                    help="--mode lm: a registered architecture "
                         "(repro_torch.configs.all_archs()); its smoke "
                         "config is served")
    ap.add_argument("--new-tokens", type=int, default=16,
                    help="--mode lm: tokens generated after the prompt")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="--mode lm: sampling temperature (0: greedy)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.mode == "lm":
        for flag, given in (("--listen", args.listen is not None),
                            ("--mesh", args.mesh is not None),
                            ("--slo-ms", args.slo_ms),
                            ("--trace-out", args.trace_out),
                            ("--metrics-every", args.metrics_every),
                            ("--guard", args.guard),
                            ("--journal-dir", args.journal_dir)):
            if given:
                ap.error(f"{flag} is a --mode tgn feature")
    if args.mesh is not None and args.listen is not None:
        ap.error("--mesh serves the offline fleet, not --listen")
    if args.restore and not args.snapshot_dir:
        ap.error("--restore needs --snapshot-dir")
    if args.snapshot_every and not args.snapshot_dir:
        ap.error("--snapshot-every needs --snapshot-dir")
    if args.slo_ms < 0:
        ap.error("--slo-ms must be >= 0")
    if not 0.0 < args.slo_objective < 1.0:
        ap.error("--slo-objective must be in (0, 1)")
    if args.trace_every < 1:
        ap.error("--trace-every must be >= 1")
    if args.metrics_every < 0:
        ap.error("--metrics-every must be >= 0")
    if args.max_restores < 1:
        ap.error("--max-restores must be >= 1")
    if args.quarantine_slo_burn < 0:
        ap.error("--quarantine-slo-burn must be >= 0")
    if args.quarantine_slo_burn and not args.slo_ms:
        ap.error("--quarantine-slo-burn needs --slo-ms")
    if args.journal_fsync_ms < 0:
        ap.error("--journal-fsync-ms must be >= 0")
    if args.dedup_window < 1:
        ap.error("--dedup-window must be >= 1")
    return (run_tgn if args.mode == "tgn" else run_lm)(args)


if __name__ == "__main__":
    main()
