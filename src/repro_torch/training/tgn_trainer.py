"""TGN training and knowledge distillation (the paper's §III-A / §VI
workflow).

Port of ``repro.training.tgn_trainer``.

Teacher: TGN-attn (vanilla temporal attention, cosine time encoder),
trained with self-supervised temporal link prediction on the
chronological stream.

Students: SAT [+LUT] [+NP(k)], trained with the link loss plus the Eq.-17
soft cross-entropy against the FROZEN teacher's attention logits, replayed
over the same stream. Teacher and student each keep their own vertex
state; their neighbour ring buffers coincide, since the buffer's dynamics
do not depend on the parameters.

Gradients flow within a batch (through the GRU memory update and the
aggregator), and the carried vertex state is detached between batches, as
in the reference TGN. Training differentiates the ``ref`` tier with
``torch.autograd`` (the reference trains on its ``ref`` tier too), with
the LUT folds recomputed inside the graph on every step. The teacher's
forward during distillation runs under ``torch.no_grad()``.

Initial parameters are drawn from ``torch.Generator``s seeded as the
reference seeds its keys (``seed``, ``seed + 7``), so they are not the
reference's draws; batches and negatives come from the numpy data layer
and are the reference's. Every entry point runs on ``cuda`` unless it is
given ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as tnf

from repro_torch import tree
from repro_torch.utils import FrozenConfig, resolve_device
from repro_torch.core import distill, tgn
from repro_torch.core.pipeline import build_pipeline
from repro_torch.data import stream as stream_mod
from repro_torch.data.temporal_graph import TemporalGraph
from repro_torch.training import optim as opt_mod
from repro_torch.training.train_loop import value_and_grad


@dataclasses.dataclass(frozen=True)
class TGNTrainConfig(FrozenConfig):
    batch_size: int = 100
    epochs: int = 3
    lr: float = 1e-3
    kd_weight: float = 1.0
    kd_temperature: float = 1.0   # paper sets T=1
    seed: int = 0


def features(g: TemporalGraph, cfg: tgn.TGNConfig, device) -> tuple:
    """``(node_feats or None, edge_feats)`` of ``g`` on ``device``; a graph
    with no edge features gets zeros of the model's ``f_edge``."""
    node_feats = (torch.as_tensor(g.node_feats, device=device)
                  if g.node_feats is not None else None)
    edge_feats = (torch.as_tensor(g.edge_feats, device=device)
                  if g.edge_feats.shape[1] else
                  torch.zeros((g.n_edges, cfg.f_edge), device=device))
    return node_feats, edge_feats


def batch_tensors(batch: stream_mod.EdgeBatch, device) -> tuple:
    """``(src, dst, eid, ts, valid, neg_dst)`` on ``device``."""
    return tuple(torch.as_tensor(x, device=device) for x in batch)


def _embed_negatives(pipe, params, aux, state, node_feats, edge_feats,
                     neg_dst, ts):
    h, _, _, _ = pipe.embed(params, aux, state, edge_feats, node_feats,
                            neg_dst, ts)
    return h


# ---------------------------------------------------------------------------
# teacher
# ---------------------------------------------------------------------------


def make_teacher_loss(cfg: tgn.TGNConfig, node_feats, edge_feats):
    """``loss_fn(params, state, b) -> (loss, new_state)``: the link BCE of
    one batch ``b = batch_tensors(...)``, masked by ``valid``, on the ref
    tier of ``edge_feats``' device."""
    pipe = build_pipeline(cfg, device=edge_feats.device)

    def loss_fn(params, state, b):
        src, dst, eid, ts, valid, neg = b
        aux = pipe.prepare(params)   # in the graph: gradients reach folds
        out = pipe.step(params, aux, state, (src, dst, eid, ts, valid),
                        edge_feats, node_feats)
        neg_emb = _embed_negatives(pipe, params, aux, out.state, node_feats,
                                   edge_feats, neg, ts)
        pos = tgn.link_score(params, out.emb_src, out.emb_dst)
        negs = tgn.link_score(params, out.emb_src, neg_emb)
        w = valid.to(torch.float32)
        loss = ((tnf.softplus(-pos) * w).sum()
                + (tnf.softplus(negs) * w).sum()) / (2 * w.sum().clamp(min=1))
        return loss, out.state

    return loss_fn


def make_teacher_step(cfg: tgn.TGNConfig, ocfg: opt_mod.OptimConfig,
                      node_feats, edge_feats):
    """``step(params, opt_state, state, b) -> (params, opt_state, state,
    loss)``; the returned state is detached."""
    loss_fn = make_teacher_loss(cfg, node_feats, edge_feats)

    def step(params, opt_state, state, b):
        loss, new_state, grads = value_and_grad(loss_fn, params, state, b)
        opt_state, params = opt_mod.apply_updates(ocfg, opt_state, grads,
                                                  params)
        return params, opt_state, tree.detach(new_state), loss

    return step


def train_teacher(g: TemporalGraph, cfg: tgn.TGNConfig,
                  tcfg: TGNTrainConfig = TGNTrainConfig(), device=None):
    """Train the teacher from seeded random weights over the train window
    for ``tcfg.epochs`` epochs. Returns ``(params, losses)``."""
    device = resolve_device(device)
    node_feats, edge_feats = features(g, cfg, device)
    params = tgn.init_params(torch.Generator().manual_seed(tcfg.seed), cfg,
                             device)
    ocfg = opt_mod.OptimConfig(name="adamw", lr=tcfg.lr, weight_decay=0.0)
    opt_state = opt_mod.init_state(ocfg, params)
    step = make_teacher_step(cfg, ocfg, node_feats, edge_feats)

    train_sl, _, _ = stream_mod.chronological_split(g)
    losses = []
    for epoch in range(tcfg.epochs):
        state = tgn.init_state(cfg, device)
        for batch in stream_mod.fixed_count(g, tcfg.batch_size,
                                            window=train_sl,
                                            seed=tcfg.seed + epoch):
            params, opt_state, state, loss = step(
                params, opt_state, state, batch_tensors(batch, device))
            losses.append(loss)
    # one host sync for the whole run
    return params, (torch.stack(losses).tolist() if losses else [])


# ---------------------------------------------------------------------------
# student distillation
# ---------------------------------------------------------------------------

_PARTS = ("link", "kd", "total")


def make_distill_loss(s_cfg: tgn.TGNConfig, t_cfg: tgn.TGNConfig,
                      tcfg: TGNTrainConfig, node_feats, edge_feats):
    """``loss_fn(s_params, t_params, s_state, t_state, b) -> (total,
    (s_state, t_state, parts))``: the student's link BCE plus
    ``kd_weight`` times Eq. 17 against the teacher's logits. Teacher and
    student are two compositions of the same stage registry; the teacher
    replays frozen through its own pipeline."""
    device = edge_feats.device
    t_pipe = build_pipeline(t_cfg, device=device)
    s_pipe = build_pipeline(s_cfg, device=device)

    def loss_fn(s_params, t_params, s_state, t_state, b):
        src, dst, eid, ts, valid, neg = b
        batch = (src, dst, eid, ts, valid)
        with torch.no_grad():
            t_out = t_pipe.step(t_params, t_pipe.prepare(t_params), t_state,
                                batch, edge_feats, node_feats)
        s_aux = s_pipe.prepare(s_params)
        s_out = s_pipe.step(s_params, s_aux, s_state, batch, edge_feats,
                            node_feats)
        neg_emb = _embed_negatives(s_pipe, s_params, s_aux, s_out.state,
                                   node_feats, edge_feats, neg, ts)
        pos = tgn.link_score(s_params, s_out.emb_src, s_out.emb_dst)
        negs = tgn.link_score(s_params, s_out.emb_src, neg_emb)
        total, parts = distill.distill_loss(
            s_out.attn_logits, t_out.attn_logits,
            s_out.nbr_valid & t_out.nbr_valid, pos, negs,
            temperature=tcfg.kd_temperature, kd_weight=tcfg.kd_weight)
        return total, (s_out.state, t_out.state, parts)

    return loss_fn


def make_distill_step(s_cfg: tgn.TGNConfig, t_cfg: tgn.TGNConfig,
                      ocfg: opt_mod.OptimConfig, tcfg: TGNTrainConfig,
                      node_feats, edge_feats):
    """``step(s_params, t_params, opt_state, s_state, t_state, b) ->
    (s_params, opt_state, s_state, t_state, parts)``; states detached."""
    loss_fn = make_distill_loss(s_cfg, t_cfg, tcfg, node_feats, edge_feats)

    def step(s_params, t_params, opt_state, s_state, t_state, b):
        _, (s_new, t_new, parts), grads = value_and_grad(
            loss_fn, s_params, t_params, s_state, t_state, b)
        opt_state, s_params = opt_mod.apply_updates(ocfg, opt_state, grads,
                                                    s_params)
        return (s_params, opt_state, tree.detach(s_new), tree.detach(t_new),
                tree.detach(parts))

    return step


def distill_student(g: TemporalGraph, teacher_params: dict,
                    t_cfg: tgn.TGNConfig, s_cfg: tgn.TGNConfig,
                    tcfg: TGNTrainConfig = TGNTrainConfig(), device=None):
    """Distill a student from ``teacher_params`` over the train window, its
    LUT boundaries fitted to the window's inter-event times (§III-C).
    Returns ``(s_params, [{"link", "kd", "total"} per step])``."""
    device = resolve_device(device)
    node_feats, edge_feats = features(g, s_cfg, device)
    teacher_params = tree.map(lambda x: torch.as_tensor(x, device=device),
                              teacher_params)
    train_sl, _, _ = stream_mod.chronological_split(g)
    dt_samples = _dt_samples(g, train_sl)
    s_params = tgn.init_params(torch.Generator().manual_seed(tcfg.seed + 7),
                               s_cfg, device, dt_samples=dt_samples)
    ocfg = opt_mod.OptimConfig(name="adamw", lr=tcfg.lr, weight_decay=0.0)
    opt_state = opt_mod.init_state(ocfg, s_params)
    step = make_distill_step(s_cfg, t_cfg, ocfg, tcfg, node_feats,
                             edge_feats)

    parts = []
    for epoch in range(tcfg.epochs):
        s_state = tgn.init_state(s_cfg, device)
        t_state = tgn.init_state(t_cfg, device)
        for batch in stream_mod.fixed_count(g, tcfg.batch_size,
                                            window=train_sl,
                                            seed=tcfg.seed + 31 + epoch):
            s_params, opt_state, s_state, t_state, p = step(
                s_params, teacher_params, opt_state, s_state, t_state,
                batch_tensors(batch, device))
            parts.append(torch.stack([p[k] for k in _PARTS]))
    # one host sync for the whole run
    rows = torch.stack(parts).tolist() if parts else []
    return s_params, [dict(zip(_PARTS, r)) for r in rows]


def _dt_samples(g: TemporalGraph, sl: slice) -> np.ndarray:
    """Empirical inter-event time deltas per node over the train window:
    the LUT bucketing distribution (paper Fig. 1)."""
    last = {}
    out = []
    for i in range(sl.start or 0, sl.stop):
        for v in (int(g.src[i]), int(g.dst[i])):
            t = float(g.ts[i])
            if v in last:
                out.append(t - last[v])
            last[v] = t
    return np.asarray(out if out else [1.0], np.float64)


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------


def evaluate_ap(params: dict, cfg: tgn.TGNConfig, g: TemporalGraph,
                window: slice, batch_size: int = 100,
                warm_window: slice | None = None, seed: int = 123,
                device=None) -> float:
    """Chronological replay AP over ``window``, the state warmed over
    ``warm_window`` first (transductive TGN evaluation)."""
    device = resolve_device(device)
    node_feats, edge_feats = features(g, cfg, device)
    params = tree.map(lambda x: torch.as_tensor(x, device=device), params)
    pipe = build_pipeline(cfg, device=device)
    aux = pipe.prepare(params)

    def run(state, b):
        src, dst, eid, ts, valid, neg = b
        out = pipe.step(params, aux, state, (src, dst, eid, ts, valid),
                        edge_feats, node_feats)
        neg_emb = _embed_negatives(pipe, params, aux, out.state, node_feats,
                                   edge_feats, neg, ts)
        pos = tgn.link_score(params, out.emb_src, out.emb_dst)
        negs = tgn.link_score(params, out.emb_src, neg_emb)
        return out.state, pos, negs

    with torch.no_grad():
        state = tgn.init_state(cfg, device)
        if warm_window is not None:
            for batch in stream_mod.fixed_count(g, batch_size,
                                                window=warm_window,
                                                seed=seed):
                state, _, _ = run(state, batch_tensors(batch, device))
        pos_all, neg_all, valid_all = [], [], []
        for batch in stream_mod.fixed_count(g, batch_size, window=window,
                                            seed=seed):
            b = batch_tensors(batch, device)
            state, pos, negs = run(state, b)
            pos_all.append(pos)
            neg_all.append(negs)
            valid_all.append(b[4])
        valid = torch.cat(valid_all)
        ap = distill.average_precision(torch.cat(pos_all)[valid],
                                       torch.cat(neg_all)[valid])
    return float(ap)
