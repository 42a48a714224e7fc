"""The port's main-path configurations, one definition for the scripts that
run them on the GPU (``chip_smoke.py`` and ``repro_torch.launch.profile``).

``build_variant``: a Wikipedia-sized synthetic graph at the dataset's
published counts (8,227 users, 1,000 items, 157,474 edges, 172 edge
features, no node features) serving any registry variant of the ladder
(``core.pipeline.VARIANTS`` and ``SAMPLER_VARIANTS``; the teacher with 2
heads). ``build`` is ``build_variant("sat+lut+np4", ...)``.

``build_gdelt``: the GDELT-like graph of ``data.temporal_graph.gdelt_like``
(500 + 500 vertices, 200 static node features, no edge features, seed 2)
over as many edges as the Wikipedia path. The fused tier does not cover
node features, so on it the staged tier runs.

All run at paper width (f_mem = f_time = f_emb = 100, m_r = 10, 128 LUT
entries; the student ``sat+lut+np4`` keeps k = 4) in batches of B = 200
edges, with random weights from a fixed seed.

``WINDOW_S``: the same path served in windows of stream time
(``stream.time_window``), at most B edges a window, so the kernels see
ragged counts of valid rows.

``train_graph``: the Wikipedia path's stream cut to its first 14,284
edges, whose chronological train window is ``TRAIN_STEPS`` batches of
``TRAIN_B`` edges: the depth at which chip_smoke trains the teacher and
distills the student.

``LM_*`` and ``lm_prompts``: the language models' serving path, served
at full width (``LM_FULL``) and at every architecture's smoke config.
``LM_TRAIN_*``: their training path (``launch/lm_train_smoke.py``).

``fleet_session``: a multi-tenant session on the Wikipedia path (``FLEET``:
eight tenants on five lanes, the teacher on its own parameter set), on
one device or on the sharded fabric's mesh (``FABRIC_MESHES``: one card
stands for every device of a mesh), ``fleet_feeds``: each tenant's own
contiguous window of the stream, and ``lane_kernels``: the port kernels a
cohort's step launches.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import pipeline as pl
from repro_torch.core import tgn
from repro_torch.data import temporal_graph as tgd

B = 200                      # edges per batch; R = 2B vertex rows
GRAPH = dict(n_users=8227, n_items=1000, n_edges=157474, f_edge=172)
WIDTH = 100                  # f_mem = f_time = f_emb
M_R = 10                     # ring-buffer slots
K = 4                        # winners kept by the student's prune-then-fetch
E = 128                      # LUT entries
SEED = 0
STUDENT = f"sat+lut+np{K}"
#: the ladder served on the Wikipedia path: Table II's rows, then the
#: student's sampler variants
LADDER = pl.VARIANTS + pl.SAMPLER_VARIANTS[1:]
#: the fleet: (variant, tier, parameter set; None = the session's default,
#: the student's weights). 3 np4 fused, 2 np4 staged, 1 np4 + reservoir
#: fused, 1 sat+lut staged (the EU at k = 10), and the teacher on its own
#: weights (staged: its stages have no kernel); five cohorts.
FLEET = (((STUDENT, "fused", None),) * 3 + ((STUDENT, "staged", None),) * 2
         + ((f"{STUDENT}+reservoir", "fused", None),
            ("sat+lut", "staged", None),
            ("vanilla+cosine", "staged", "teacher")))
FLEET_ROUNDS = 20            # rounds of B edges a tenant
#: the fabric's meshes: the true one-device mesh, a tenant axis, and a
#: tenant x vertex mesh
FABRIC_MESHES = ("tenant=1", "tenant=4", "tenant=2,vertex=2")
#: the fabric's fleet: ``FLEET`` and a ref-tier cohort of two np4 tenants
FABRIC = FLEET + ((STUDENT, "ref", None),) * 2
FABRIC_ROUNDS = 10           # rounds of each mesh and round kind
#: the fabric's tables: the graph's 9,227 vertices and the padding vertex
#: 0 of TGN's preprocessing of Wikipedia (ids from 1), 9,228 = 4 x 2,307,
#: so a vertex axis of 2 or 4 splits V (the rules drop an axis that does
#: not divide V, and 9,227 is prime)
FABRIC_V = GRAPH["n_users"] + GRAPH["n_items"] + 1
#: the windowed path: ``stream.time_window`` windows of 12 hours of stream
#: time, at most B edges each; the first 50 hold 19-200 edges (mean 144.5)
WINDOW_S = 43_200.0
N_WINDOWS = 50
TRAIN_B = 100                # edges per training batch
TRAIN_STEPS = 100            # batches in the cut stream's train window


def wikipedia_graph():
    return tgd.generate(tgd.StreamConfig(**GRAPH, f_feat=0, seed=SEED))


def config(g, variant: str) -> tgn.TGNConfig:
    """``variant`` over graph ``g`` at paper width."""
    return pl.variant_config(variant, n_nodes=g.cfg.n_nodes,
                             n_edges=g.n_edges, f_edge=g.cfg.f_edge,
                             f_feat=g.cfg.f_feat, f_mem=WIDTH, f_time=WIDTH,
                             f_emb=WIDTH, m_r=M_R, lut_entries=E)


def model(g, variant: str, device) -> tuple:
    """``(cfg, params)`` of ``variant`` over graph ``g`` at paper width,
    params on ``device``."""
    cfg = config(g, variant)
    params = tgn.init_params(torch.Generator().manual_seed(SEED), cfg,
                             device)
    return cfg, params


def train_graph(g=None) -> tgd.TemporalGraph:
    """The first 14,284 edges of the Wikipedia path's stream ``g`` (built
    when not given): ``stream.chronological_split`` keeps 70% of them,
    ``TRAIN_STEPS`` batches of ``TRAIN_B``, for training."""
    g = wikipedia_graph() if g is None else g
    n = 14_284
    return dataclasses.replace(
        g, src=g.src[:n], dst=g.dst[:n], ts=g.ts[:n],
        edge_feats=g.edge_feats[:n], cfg=g.cfg.replace(n_edges=n))


def build_variant(variant: str, device) -> tuple:
    """``(graph, cfg, params)`` of ``variant`` on the Wikipedia path,
    params on ``device``."""
    g = wikipedia_graph()
    return (g, *model(g, variant, device))


def build(device) -> tuple:
    """``(graph, cfg, params)`` of the student on the Wikipedia path."""
    return build_variant(STUDENT, device)


def build_gdelt(device) -> tuple:
    """``(graph, cfg, params)`` of the student on the GDELT-like path,
    params on ``device``; ``graph.node_feats`` is (1000, 200)."""
    g = tgd.gdelt_like(n_edges=GRAPH["n_edges"])
    return (g, *model(g, STUDENT, device))


def fleet_session(g, device, lanes=FLEET, coalesce: bool = True,
                  mesh=None, n_nodes: int | None = None):
    """``(session, tenant ids)``: one tenant a lane of ``lanes`` on graph
    ``g`` at paper width, on the student's weights unless the lane names a
    parameter set (registered with weights for its variant, from the
    seed). With ``mesh`` (a ``tgn_sharding.TenantMesh``) the session is
    the sharded fabric's; ``n_nodes`` overrides the tables' vertex
    count."""
    from repro_torch.serving.cluster import ShardedSessionManager
    from repro_torch.serving.session import SessionManager
    cfg, params = model(g, STUDENT, device)
    if n_nodes is not None:
        cfg = cfg.replace(n_nodes=n_nodes)
    kw = dict(model=cfg, use_kernels="staged", coalesce=coalesce)
    if mesh is None:
        mgr = SessionManager(params, g.edge_feats, g.node_feats,
                             device=device, **kw)
    else:
        mgr = ShardedSessionManager(params, g.edge_feats, g.node_feats,
                                    mesh=mesh, **kw)
    for variant, _tier, pset in lanes:
        if pset is not None and pset not in mgr.param_store:
            mgr.register_params(pset, model(g, variant, device)[1])
    tids = [mgr.add_tenant(v, use_kernels=tier, params=pset, name=f"t{i}")
            for i, (v, tier, pset) in enumerate(lanes)]
    return mgr, tids


def lane_kernels(desc) -> tuple:
    """The port kernels a cohort's step launches, from its pipeline's
    ``describe()``: ``fused_step`` on the fused tier, else the staged
    kernels of its LUT and SAT stages (none for the cosine stages)."""
    if "fused_step" in desc:
        return ("fused_step",)
    names = ()
    if desc.get("memory_updater") == "gru:lut-cuda":
        names += ("lut_encode", "gru_cell")
    if desc["aggregator"] == "attn:sat-lut-cuda":
        names += ("sat_aggregate",)
    return names


def fleet_feeds(g, n_tenants: int, rounds: int) -> list:
    """Tenant i's ``rounds`` batches of B edges: its own contiguous window
    of the stream, edges [i * rounds * B, (i + 1) * rounds * B)."""
    from repro_torch.data import stream
    span = rounds * B
    return [list(stream.fixed_count(g, B, window=slice(i * span,
                                                       (i + 1) * span)))
            for i in range(n_tenants)]


def step_traffic(g, cfg, params, tier: str, device) -> dict:
    """``launch.hlo_analysis.step_traffic`` of one ``TGNPipeline.step`` on
    ``tier`` at ``device``: the first batch of B edges of ``g`` on a fresh
    state, the parameters, prepared tables, state, batch and edge features
    passed as the step's inputs (the reference's jaxpr takes them as its
    invars and constvars). Adds ``launches``: the ``kernels.ops.LAUNCHES``
    deltas of the traced step."""
    from repro_torch.data import stream
    from repro_torch.kernels import ops
    from repro_torch.launch import hlo_analysis

    pipe = pl.build_pipeline(cfg, use_kernels=tier, device=device)
    aux = pipe.prepare(params)
    b = next(iter(stream.fixed_count(g, B, window=slice(0, B))))
    batch = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                  for a in (b.src, b.dst, b.eid, b.ts, b.valid))
    ef = torch.as_tensor(g.edge_feats, device=device)
    before = ops.launch_counts()
    out = hlo_analysis.step_traffic(
        lambda p, a, s, bt, e: pipe.step(p, a, s, bt, e), params, aux,
        pipe.init_state(), batch, ef)
    out["launches"] = {n: c - before[n]
                       for n, c in ops.launch_counts().items()}
    return out


# ---------------------------------------------------------------------------
# the language models' serving path (chip_smoke's LM phase)
# ---------------------------------------------------------------------------

#: architectures served at their full published width and depth on one
#: card: qwen3-8b (8.19 B parameters, 32.8 GB in fp32 as stored), and two
#: that cost seconds: mamba2-130m (SSD at d_state 128, chunk 256) and
#: whisper-tiny (encoder-decoder with cross K/V)
LM_FULL = ("qwen3_8b", "mamba2_130m", "whisper_tiny")
LM_B = 4                     # prompts generate serves at full width
LM_SMOKE_B = 2               # prompts of the smoke configs, card vs CPU
LM_PROMPT = 8                # tokens a prompt
LM_NEW = 16                  # tokens generated after it
LM_LONG = 2048               # the long prefill (B = 1): 4 q-blocks x 2 k-blocks
LM_PRUNE_KEEP = 8            # kv_prune_keep of the pruned-decode check
LM_SEED = 0


#: the training path: one step of every smoke config at B x S tokens (B
#: even, so grad_accum = 2 splits it), lr 1e-3, taken at step 1 of a
#: one-step warmup (at step 0 the schedule's scale is 0)
LM_TRAIN_SEED = 0
LM_TRAIN_B, LM_TRAIN_S = 4, 32
LM_TRAIN_LR = 1e-3
#: mamba2-130m at its published config, uncut (24 layers, d_model 768,
#: vocab 50,280, chunk 256): 5 steps of B x S, and the first step's loss
#: and gradients at B x S = 1 x 256 against the CPU
LM_TRAIN_MAMBA = dict(arch="mamba2_130m", batch=4, seq=2048, steps=5,
                      cpu_batch=1, cpu_seq=256)
#: qwen3-8b at its published width, its 36 layers cut to 4 (2.016 B
#: parameters; with AdamW's fp32 moments and the gradients 32.3 GB
#: resident): 3 steps of B x S = 1 x 4,096, 8 x 4 query x key blocks and 8
#: loss chunks, checkpointed after step 2
LM_TRAIN_QWEN = dict(arch="qwen3_8b", n_layers=4, batch=1, seq=4096,
                     steps=3, ckpt_after=2)
#: ``launch/train.py --mode lm`` killed once its step-3 checkpoint is
#: written and rerun, against an uninterrupted run
LM_TRAIN_CLI = dict(arch="qwen3_8b", steps=6, ckpt_every=3, batch=8,
                    seq=64)


def lm_prompts(vocab: int, batch: int, n: int = LM_PROMPT,
               seed: int = LM_SEED) -> torch.Tensor:
    """``batch`` prompts of ``n`` tokens, uniform over ``vocab``, on the
    CPU (int32)."""
    return torch.as_tensor(
        np.random.RandomState(seed).randint(0, vocab, size=(batch, n)),
        dtype=torch.int32)
