"""Algorithm 1 as pluggable stages, for every variant of the ladder.

Port of ``repro.core.stages``:

  MemoryUpdater  (MUU)    consume cached mail -> updated memory rows
                          (cosine reference | LUT reference | LUT + GRU
                          kernels)
  Sampler                 read the ring buffer. Two dataflows:
                            fetch-all         the vanilla teacher scores
                                              from neighbor memory, so it
                                              gathers all m_r rows
                            prune-then-fetch  SAT: select k slots from the
                                              timestamps/ids ONLY, then
                                              gather just the k winners
                          Selection policies (``SAMPLERS``): "recent" (SAT
                          top-k), "uniform" and time-decayed "reservoir"
                          (a stateless hash, so selection is deterministic)
  Aggregator     (EU)     vanilla attention | SAT reference | SAT-aggregate
                          kernel
  Committer               chronological last-write-wins commit (§IV-B)
  fused step              the single-pass tier: selection metadata, then
                          ONE fused_step call (kernels/csrc/fused_step.cu)

Kernels exist for the LUT paths only, as in the reference: a stage without
one runs its torch reference on every tier, and its name ends in ``-ref``.

Stages are closures built from a frozen ``TGNConfig``; per-call inputs are
``(params, aux, ...)`` where ``aux = prepare(params)`` carries the folded
LUT tables and the kernels' parameter packs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import attention as attn_mod
from repro_torch.core import mailbox, memory, pruning, time_encode as te
from repro_torch.core import updater
from repro_torch.kernels import ops as kops
from repro_torch.utils import per_tenant, tenant_matmul

#: Kernel-backend tiers. ``use_kernels`` accepts a tier name or a bool
#: (False -> "ref", True -> "staged"):
#:   ref     torch stage references (the numerics oracle)
#:   staged  one kernel per unit (LUT encode, GRU, SAT aggregate)
#:   fused   the single-pass step (fused_step: MUU + winner gather + EU)
KERNEL_TIERS = ("ref", "staged", "fused")


def kernel_tier(use_kernels) -> str:
    """Normalize a ``use_kernels`` value (bool-like or tier name)."""
    if isinstance(use_kernels, str):
        if use_kernels in KERNEL_TIERS:
            return use_kernels
        raise ValueError(f"unknown kernel tier {use_kernels!r}; pass a "
                         f"bool or one of {KERNEL_TIERS}")
    return "staged" if use_kernels else "ref"


def fused_supported(cfg) -> bool:
    """The fused step covers SAT attention + LUT encoder (any prune budget
    and sampler) without static node features (the paper's
    Wikipedia/Reddit setting)."""
    return (cfg.attention == "sat" and cfg.encoder == "lut"
            and cfg.f_feat == 0)


def resolved_tier(cfg, use_kernels) -> str:
    """The tier that runs for ``cfg``: as in the reference, ``"fused"`` on
    a configuration outside ``fused_supported`` runs the staged tier."""
    tier = kernel_tier(use_kernels)
    if tier == "fused" and not fused_supported(cfg):
        return "staged"
    return tier


class Neighborhood(NamedTuple):
    """What the sampler hands the aggregator: the k fetched slots, plus the
    full m_r-slot views."""
    s_nbr: torch.Tensor         # (2B, k, f_mem) masked neighbor memory
    e_nbr: torch.Tensor         # (2B, k, f_edge) masked edge features
    dt: torch.Tensor            # (2B, k) time deltas of fetched slots
    valid: torch.Tensor         # (2B, k) fetched-slot validity
    logits: torch.Tensor | None  # (2B, k) SAT logits (None: fetch-all)
    full_logits: torch.Tensor   # (2B, m_r) pre-softmax scores
    full_valid: torch.Tensor    # (2B, m_r) ring-buffer validity
    full_dt: torch.Tensor       # (2B, m_r) time deltas of every slot


class Selection(NamedTuple):
    """Prune-then-fetch metadata: everything selection decides from
    timestamps/ids alone, before any memory/feature gather."""
    ids: torch.Tensor           # (2B, k) int32 winner vertex ids
    eids: torch.Tensor          # (2B, k) int32 winner edge-feature rows
    dt: torch.Tensor            # (2B, k) winner time deltas
    logits: torch.Tensor        # (2B, k) SAT logits (NEG_INF where invalid)
    valid: torch.Tensor         # (2B, k) bool winner validity
    full_logits: torch.Tensor   # (2B, m_r)
    full_valid: torch.Tensor    # (2B, m_r)
    full_dt: torch.Tensor       # (2B, m_r)


class StageBundle(NamedTuple):
    """The resolved stage stack for one variant and tier. The fused tier
    carries ``fused`` for the step and the staged sampler and aggregator
    for ``embed``; its memory updater is None."""
    memory_updater: object      # (params, aux, state, vids, tenants) -> (s_upd, lu_upd)
    sampler: object             # (params, aux, state, ef, vids, t) -> Neighborhood
    aggregator: object          # (params, aux, nb, s_self, f_self, tenants) -> (h, logits)
    committer: object           # LastWriteWinsCommitter
    names: dict                 # stage name -> backend label
    variant_id: int             # lane id of this stage program (variant_lane)
    fused: object = None        # fused tier only: the post-prune datapath


#: Lane ids: every distinct resolved stage PROGRAM (the knobs that change
#: which code runs inside ``TGNPipeline.step``, not the table dims) gets a
#: small stable integer; a cohort's ``describe()`` reports it as ``lane``.
_VARIANT_LANES: dict[tuple, int] = {}


def variant_lane(cfg, use_kernels=False) -> int:
    """The lane id of ``cfg``'s resolved stage program. Two configs share a
    lane iff ``build_stages`` resolves them to the same code: attention,
    encoder, prune budget and sampler (tau too for the reservoir, which its
    closure bakes in), the RESOLVED kernel tier and the ring width the
    prune clamp sees."""
    key = (cfg.attention, cfg.encoder, cfg.prune_k, cfg.sampler,
           float(cfg.reservoir_tau) if cfg.sampler == "reservoir" else None,
           resolved_tier(cfg, use_kernels), cfg.m_r)
    return _VARIANT_LANES.setdefault(key, len(_VARIANT_LANES))


# ---------------------------------------------------------------------------
# aux: folded LUT rows + the kernels' parameter packs (§III-C)
# ---------------------------------------------------------------------------


def make_prepare(cfg, use_kernels=False):
    """Build ``prepare(params) -> aux``; empty for the cosine encoder.
    With the LUT encoder:
      folded_gru / folded_attn   LUT tables folded through the time rows of
                                 W_i / W_v (te.fold_projection)
      packed_gru / packed_lut_gru
                                 the staged MUU kernels' packs (staged tier)
      packed_sat                 the SAT aggregate kernel's pack (staged
                                 tier, and fused tier for ``embed``)
      packed_fused               the fused step's pack (fused tier)
    """
    tier = resolved_tier(cfg, use_kernels)

    def prepare(params: dict) -> dict:
        if cfg.encoder != "lut":
            return {}
        gcfg = cfg.gru
        gru_p, attn_p = params["gru"], params["attn"]
        dkv = cfg.f_mem + cfg.f_edge
        folded_gru = te.fold_projection(params["time"],
                                        gru_p["w_i"][gcfg.f_mail_raw:])
        folded_attn = te.fold_projection(params["time"], attn_p["w_v"][dkv:])
        aux = {"folded_gru": folded_gru, "folded_attn": folded_attn}
        if tier == "staged":
            aux["packed_gru"] = kops.pack_gru_params(
                gru_p["w_i"][:gcfg.f_mail_raw], gru_p["w_h"], gru_p["b_i"],
                gru_p["b_h"])
            aux["packed_lut_gru"] = kops.pack_lut_params(
                folded_gru["boundaries"], folded_gru["table"])
        if tier != "ref":
            aux["packed_sat"] = kops.pack_sat_params(
                attn_p["w_v"][:dkv], attn_p["b_v"],
                folded_attn["boundaries"], folded_attn["table"])
        if tier == "fused":
            aux["packed_fused"] = kops.pack_fused_params(
                gru_p, attn_p, folded_gru, folded_attn, gcfg.f_mail_raw,
                cfg.f_mem, cfg.f_edge)
        return aux

    return prepare


# ---------------------------------------------------------------------------
# MemoryUpdater (MUU)
# ---------------------------------------------------------------------------


def make_memory_updater(cfg, staged: bool):
    """UPDT: ``muu(params, aux, state, vids, tenants=1) -> (s_upd,
    lu_upd)`` from the cached mail of ``vids``; vertices without valid
    mail keep their rows. The kernels serve the LUT encoder; the cosine
    encoder runs its torch reference on every tier, its products on each
    of the ``tenants`` blocks of ``vids`` on its own
    (``memory.update_memory``)."""
    gcfg = cfg.gru

    if staged and cfg.encoder == "lut":
        def muu(params, aux, state, vids, tenants=1):
            vids = vids.long()
            mail_valid = state.mail_valid[vids]
            mail_ts = state.mail_ts[vids]
            s_prev = state.memory[vids]
            lu_prev = state.last_update[vids]
            # LUT row fetch kernel -> fused GRU kernel: the folded time rows
            # enter the GRU as an additive input-gate term.
            time_rows = kops.lut_encode(mail_ts - lu_prev,
                                        aux["packed_lut_gru"])
            s_new = kops.gru_cell(state.mail[vids], s_prev,
                                  aux["packed_gru"], extra=time_rows)
            s_upd = torch.where(mail_valid[:, None], s_new, s_prev)
            lu_upd = torch.where(mail_valid, mail_ts, lu_prev)
            return s_upd, lu_upd

        return muu, "gru:lut-cuda"

    def muu(params, aux, state, vids, tenants=1):
        vids = vids.long()
        return memory.update_memory(
            params["gru"], params["time"], gcfg,
            state.mail[vids], state.mail_ts[vids], state.mail_valid[vids],
            state.memory[vids], state.last_update[vids],
            encoder=cfg.encoder, lut_folded=aux.get("folded_gru"),
            tenants=tenants)

    return muu, f"gru:{cfg.encoder}-ref"


# ---------------------------------------------------------------------------
# Sampler: fetch-all (vanilla) or prune-then-fetch (SAT) with a policy
# ---------------------------------------------------------------------------

#: Selection policies of prune-then-fetch:
#:   recent     the paper's: SAT top-k over the FIFO ring buffer
#:   uniform    k valid slots uniformly at random (stateless hash)
#:   reservoir  time-decayed weighted reservoir (Efraimidis-Spirakis keys
#:              with weight exp(-dt/tau)): recency-biased but randomized
SAMPLERS = ("recent", "uniform", "reservoir")

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2**32`` for int64 ``a`` in [0, 2**32): the uint32
    multiply, in two 16-bit halves of ``c`` so no product leaves int64."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _stateless_uniform(eid: torch.Tensor, vids: torch.Tensor,
                       t_query: torch.Tensor) -> torch.Tensor:
    """Deterministic pseudo-uniform draws in (0, 1) per (vertex, slot): an
    integer hash of (edge id, queried vertex, the query time's bits), the
    reference's uint32 arithmetic done in int64 masked to 32 bits, so the
    draws equal the reference's bit for bit.

    eid: (B, m_r) int; vids: (B,) int; t_query: (B,) float32.
    """
    h = _mul32(eid.long() & _M32, 0x9E3779B1)
    h = h ^ _mul32(vids.long() & _M32, 0x85EBCA77)[:, None]
    tb = t_query.to(torch.float32).contiguous().view(torch.int32).long()
    h = h ^ _mul32(tb & _M32, 0xC2B2AE3D)[:, None]
    h = h ^ (h >> 15)
    h = _mul32(h, 0x2C1B3C6D)
    h = h ^ (h >> 12)
    h = _mul32(h, 0x297A2D39)
    h = h ^ (h >> 15)
    # 24 mantissa-safe bits -> (0, 1); +2^-25 keeps log(u) finite
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24)) + 2.0 ** -25


def make_selector(cfg):
    """``select(params, aux, state, vids, t_query, base=None) ->
    Selection``: the k winners from the ring buffer's timestamps/ids only.
    "recent" ranks by SAT logit; "uniform" and "reservoir" by a
    stateless-hash priority. ``vids`` are rows of the tables; over a
    cohort's stacked tables ``base`` holds each row's t·V, and the winner
    ids stay the tenant's own (ring contents)."""
    k = min(cfg.prune_k if cfg.prune_k is not None else cfg.m_r, cfg.m_r)
    policy = cfg.sampler
    tau = float(cfg.reservoir_tau)

    def select(params, aux, state, vids, t_query, base=None):
        nbr_ids, nbr_ts, nbr_eid, valid = mailbox.gather_neighbors(
            state, vids)
        dt = (t_query[:, None] - nbr_ts).clamp(min=0.0) * valid
        logits = attn_mod.sat_logits(params["attn"], dt)      # ts ONLY
        if policy == "recent" and k == cfg.m_r:                # score-all
            sel_ids, sel_eid, sel_dt = nbr_ids, nbr_eid, dt
            sel_logits, sel_valid = logits, valid
        else:
            prio = logits
            if policy != "recent":
                # the tenant's own vertex ids: a tenant draws as it would
                # alone
                prio = _stateless_uniform(
                    nbr_eid, vids if base is None else vids - base, t_query)
                if policy == "reservoir":
                    # key = u^(1/w), w = exp(-dt/tau); rank by log key
                    prio = torch.log(prio) * torch.exp(
                        (dt / tau).clamp(max=50.0))
            idx, _, sel_valid = pruning.topk_select(prio, valid, k)
            sel_ids, sel_eid, sel_dt, sel_logits = (
                torch.gather(x, 1, idx) for x in (nbr_ids, nbr_eid, dt,
                                                  logits))
            sel_logits = torch.where(sel_valid, sel_logits,
                                     torch.full_like(sel_dt, pruning.NEG_INF))
        return Selection(ids=sel_ids, eids=sel_eid, dt=sel_dt,
                         logits=sel_logits, valid=sel_valid,
                         full_logits=logits, full_valid=valid, full_dt=dt)

    if policy == "uniform":
        name = f"sampler:uniform(k={k})"
    elif policy == "reservoir":
        name = f"sampler:reservoir(k={k},tau={tau:g})"
    else:
        name = (f"sampler:prune-then-fetch(k={k})" if k < cfg.m_r
                else "sampler:score-all")
    return select, name


def _rows_of(ids: torch.Tensor, base: torch.Tensor | None) -> torch.Tensor:
    """Table rows of a tenant's vertex ids ``ids`` (R, k): + its t·V."""
    ids = ids.long()
    return ids if base is None else ids + base[:, None]


def make_sampler(cfg):
    """``sampler(params, aux, state, edge_feats, vids, t_query, base=None)
    -> Neighborhood``. SAT: selection metadata, then ONLY the winners'
    rows. Vanilla: every ring slot's rows (its scores need neighbor
    memory). ``base`` as for ``make_selector``."""
    if cfg.sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler backend {cfg.sampler!r}; "
                         f"registered backends: {SAMPLERS}")
    if cfg.attention == "vanilla":
        if cfg.sampler != "recent":
            raise ValueError(
                "alternative sampler backends (uniform/reservoir) require "
                "SAT attention: vanilla fetch-all consumes every ring-buffer "
                f"slot, so there is no selection to randomize; got "
                f"sampler={cfg.sampler!r}")

        def sampler(params, aux, state, edge_feats, vids, t_query,
                    base=None):
            nbr_ids, nbr_ts, nbr_eid, valid = mailbox.gather_neighbors(
                state, vids)
            dt = (t_query[:, None] - nbr_ts).clamp(min=0.0) * valid
            vmask = valid[..., None]
            return Neighborhood(
                s_nbr=state.memory[_rows_of(nbr_ids, base)] * vmask,
                e_nbr=edge_feats[nbr_eid.long()] * vmask, dt=dt, valid=valid,
                logits=None, full_logits=dt * 0.0, full_valid=valid,
                full_dt=dt)

        return sampler, "sampler:fetch-all"

    select, name = make_selector(cfg)

    def sampler(params, aux, state, edge_feats, vids, t_query, base=None):
        sel = select(params, aux, state, vids, t_query, base)
        vmask = sel.valid[..., None]
        s_nbr = state.memory[_rows_of(sel.ids, base)] * vmask
        e_nbr = edge_feats[sel.eids.long()] * vmask
        return Neighborhood(s_nbr=s_nbr, e_nbr=e_nbr, dt=sel.dt,
                            valid=sel.valid, logits=sel.logits,
                            full_logits=sel.full_logits,
                            full_valid=sel.full_valid, full_dt=sel.full_dt)

    return sampler, name


# ---------------------------------------------------------------------------
# Aggregator (EU)
# ---------------------------------------------------------------------------


def make_aggregator(cfg, staged: bool):
    """``aggregator(params, aux, nb, s_self, f_self, tenants=1) -> (h,
    logits)``; ``f_self`` are the rows' static node features, or None. The
    kernel serves SAT with the LUT encoder; vanilla attention and the
    cosine encoder run their torch references on every tier. Their
    products run each of the ``tenants`` blocks of rows on its own
    (``utils.per_tenant``)."""
    dkv = cfg.f_mem + cfg.f_edge

    if cfg.attention == "vanilla":
        def aggregator(params, aux, nb, s_self, f_self, tenants=1):
            return attn_mod.vanilla_attention(
                params["attn"], cfg.attn, params["time"], s_self, f_self,
                nb.s_nbr, nb.e_nbr, nb.dt, nb.valid, tenants)

        return aggregator, "attn:vanilla-ref"

    def out_transform(attn_p, s_self, f_self, agg, tenants):
        fp = attn_mod.feat_proj(attn_p["feat"], s_self, f_self, tenants)
        return (tenant_matmul(torch.cat([fp, agg], dim=-1), attn_p["w_out"],
                              tenants) + attn_p["b_out"])

    if staged and cfg.encoder == "lut":
        def aggregator(params, aux, nb, s_self, f_self, tenants=1):
            kv = torch.cat([nb.s_nbr, nb.e_nbr], dim=-1)
            agg = kops.sat_aggregate(kv, nb.dt, nb.logits, nb.valid,
                                     aux["packed_sat"])
            return (out_transform(params["attn"], s_self, f_self, agg,
                                  tenants), nb.full_logits)

        return aggregator, "attn:sat-lut-cuda"

    def aggregator(params, aux, nb, s_self, f_self, tenants=1):
        attn_p = params["attn"]
        attnw = pruning.masked_softmax(nb.logits, nb.valid)
        if cfg.encoder == "lut":
            v = (tenant_matmul(torch.cat([nb.s_nbr, nb.e_nbr], dim=-1),
                               attn_p["w_v"][:dkv], tenants)
                 + te.lut_encode(aux["folded_attn"], nb.dt) + attn_p["b_v"])
        else:
            phi = te.cosine_encode(params["time"], nb.dt)
            v = (tenant_matmul(torch.cat([nb.s_nbr, nb.e_nbr, phi], dim=-1),
                               attn_p["w_v"], tenants) + attn_p["b_v"])
        agg = per_tenant(lambda a, b: torch.einsum("bn,bnd->bd", a, b),
                         tenants, attnw, v)
        return (out_transform(attn_p, s_self, f_self, agg, tenants),
                nb.full_logits)

    return aggregator, f"attn:sat-{cfg.encoder}-ref"


# ---------------------------------------------------------------------------
# Committer — chronological last-write-wins (§IV-B)
# ---------------------------------------------------------------------------


class LastWriteWinsCommitter:
    """Per batch, exactly the chronologically-last valid update of each
    vertex survives. The winner mask is computed once per batch and shared
    by the memory commit and the mail commit. ``vids`` (2B,) — or (T, 2B)
    for a cohort, raced within each tenant's block. The commits write a
    cohort's stacked tables in place (``updater.commit_``)."""

    def winners(self, vids, vvalid, B: int):
        return updater.last_write_wins(
            vids, vvalid, updater.interleave_order(B, vids.device))

    def commit_memory(self, state, vids, winners, s_upd, lu_upd):
        """Commit updated memory rows; consuming mail invalidates it."""
        updater.commit_(state.memory, vids, s_upd, winners)
        updater.commit_(state.last_update, vids, lu_upd, winners)
        updater.commit_(state.mail_valid, vids, torch.zeros_like(winners),
                        winners)

    def commit_mail(self, state, vids, winners, new_mail, t_inst):
        """Cache new messages (Most-Recent aggregator == LWW commit)."""
        updater.commit_(state.mail, vids, new_mail, winners)
        updater.commit_(state.mail_ts, vids, t_inst, winners)
        updater.commit_(state.mail_valid, vids, torch.ones_like(winners),
                        winners)


# ---------------------------------------------------------------------------
# Fused tier: the single-pass step body (§IV, Fig. 4)
# ---------------------------------------------------------------------------


def make_fused_step(cfg):
    """The fused tier's post-prune datapath: selection metadata, then ONE
    fused_step call (MUU + winner gather + EU). ``fused(params, aux, state,
    vids, t_inst, winners, edge_feats, base=None) -> (h, s_upd, lu_upd,
    sel)``; the pipeline commits, builds the mail from ``s_upd`` and
    inserts the ring after it.

    Only ids, timestamps and validity are computed outside the call; the
    memory, mail and edge-feature rows are read inside it. Over a cohort's
    stacked tables (``base`` the rows' t·V) the winner ids are offset to
    table rows and ``hit`` names rows of the whole T·2B batch, so one call
    serves every tenant.
    """
    select, _ = make_selector(cfg)

    def fused(params, aux, state, vids, t_inst, winners, edge_feats,
              base=None):
        R = vids.shape[0]
        rows = state.memory.shape[0]
        sel = select(params, aux, state, vids, t_inst, base)
        vl = vids.long()
        sel_rows = _rows_of(sel.ids, base)
        mail_ts = state.mail_ts[vl]
        lu_prev = state.last_update[vl]
        mail_ok = state.mail_valid[vl]
        # winner-row redirect (ids only): hit[r, j] >= 0 names the batch row
        # whose phase-0 output IS the committed memory of winner (r, j).
        win_rows = torch.full((rows + 1,), -1, dtype=torch.int32,
                              device=vids.device)
        win_rows[torch.where(winners, vl, torch.full_like(vl, rows))] = \
            torch.arange(R, dtype=torch.int32, device=vids.device)
        hit = win_rows[sel_rows]
        h, s_upd = kops.fused_step(
            vids, sel_rows.to(torch.int32) if base is not None else sel.ids,
            sel.eids, hit, mail_ts - lu_prev, mail_ok, sel.dt, sel.logits,
            sel.valid, state.memory, state.mail, edge_feats,
            aux["packed_fused"])
        lu_upd = torch.where(mail_ok, mail_ts, lu_prev)
        return h, s_upd, lu_upd, sel

    return fused


def build_stages(cfg, use_kernels=False) -> StageBundle:
    """Resolve the stage stack for ``cfg``: the per-unit stages on the ref
    and staged tiers; on the fused tier the single-pass step body, and the
    staged sampler and aggregator that ``embed`` runs (as the reference's
    fused tier does). A variant outside ``fused_supported`` resolves a
    fused request to its staged stack."""
    if cfg.attention == "vanilla" and cfg.encoder != "cosine":
        raise ValueError("vanilla attention requires the cosine encoder "
                         "(its K/Q/V inputs consume the cosine encoding "
                         "directly; LUT is a SAT-path optimization)")
    tier = resolved_tier(cfg, use_kernels)
    lane = variant_lane(cfg, use_kernels)
    sampler, sampler_name = make_sampler(cfg)
    aggregator, agg_name = make_aggregator(cfg, tier != "ref")
    names = {"sampler": sampler_name, "aggregator": agg_name,
             "committer": "lww-chronological"}
    if tier == "fused":
        names["fused_step"] = "step:single-pass-cuda"
        return StageBundle(memory_updater=None, sampler=sampler,
                           aggregator=aggregator,
                           committer=LastWriteWinsCommitter(), names=names,
                           variant_id=lane, fused=make_fused_step(cfg))
    muu, names["memory_updater"] = make_memory_updater(cfg, tier == "staged")
    return StageBundle(memory_updater=muu, sampler=sampler,
                       aggregator=aggregator,
                       committer=LastWriteWinsCommitter(), names=names,
                       variant_id=lane)
