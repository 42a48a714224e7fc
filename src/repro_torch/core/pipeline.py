"""The TGN pipeline: Algorithm 1 as one composition of the stages, for
every variant of the paper's ladder (Table II):

    vanilla+cosine  ->  sat+cosine  ->  sat+lut  ->  sat+lut+np{6,4,2}

Port of ``repro.core.pipeline``:

    pipe = build_pipeline("sat+lut+np4", n_nodes=..., n_edges=...)
    aux  = pipe.prepare(params)                  # folded/packed tables
    out  = pipe.step(params, aux, state, batch, edge_feats)   # BatchOut
    h, logits, valid, dt = pipe.embed(params, aux, state, edge_feats,
                                      None, vids, t_query)

A serving fleet steps many tenants' states at once: ``batched_step``
advances a cohort's stacked tables in place, and ``CoalescedRound`` issues
every cohort of a round in one call (``serving/session.py``).

Variant registry: canonical specs are
``"<attention>+<encoder>[+np<k>][+<sampler>]"`` (samplers:
``stages.SAMPLERS``, e.g. ``"sat+lut+np4+reservoir"``); Table-II row names
and a few shorthands are aliases. An invalid spec raises with the full
token menu (``spec_menu()``).

A pipeline runs on ``cuda`` unless it is given ``device="cpu"``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.utils import resolve_device
from repro_torch.core import mailbox, memory, stages, tgn


class VariantSpec(NamedTuple):
    """The three model axes of the paper's ladder, plus the sampler
    (selection policy of prune-then-fetch; ``stages.SAMPLERS``)."""
    attention: str          # "vanilla" | "sat"
    encoder: str            # "cosine" | "lut"
    prune_k: int | None     # None | 6 | 4 | 2
    sampler: str = "recent"  # "recent" | "uniform" | "reservoir"


_REGISTRY: dict[str, VariantSpec] = {}
_ALIASES: dict[str, str] = {}


def spec_menu() -> str:
    """The full menu of valid variant-spec tokens; every spec-parsing error
    carries it."""
    return (
        "valid spec grammar: '<attention>+<encoder>[+np<k>][+<sampler>]' "
        "with attention in ('vanilla', 'sat'), encoder in ('cosine', 'lut'), "
        "np<k> an integer pruning budget (SAT only, e.g. np4), and sampler "
        f"in {stages.SAMPLERS} (SAT only; default 'recent'); "
        f"registered variants: {sorted(_REGISTRY)}; "
        f"aliases: {sorted(_ALIASES)}")


def register_variant(name: str, spec: VariantSpec,
                     aliases: tuple[str, ...] = ()) -> None:
    """Register a canonical variant name (and optional aliases)."""
    _REGISTRY[name] = spec
    for a in aliases:
        _ALIASES[a] = name


register_variant("vanilla+cosine", VariantSpec("vanilla", "cosine", None),
                 aliases=("teacher", "baseline", "Baseline", "vanilla"))
register_variant("sat+cosine", VariantSpec("sat", "cosine", None),
                 aliases=("+SAT", "sat"))
register_variant("sat+lut", VariantSpec("sat", "lut", None),
                 aliases=("+LUT",))
register_variant("sat+lut+np6", VariantSpec("sat", "lut", 6),
                 aliases=("+NP(L)", "np6"))
register_variant("sat+lut+np4", VariantSpec("sat", "lut", 4),
                 aliases=("+NP(M)", "np4", "student"))
register_variant("sat+lut+np2", VariantSpec("sat", "lut", 2),
                 aliases=("+NP(S)", "np2"))
# the np4 student with the prune-then-fetch selection policy swapped
register_variant("sat+lut+np4+uniform",
                 VariantSpec("sat", "lut", 4, "uniform"),
                 aliases=("uniform",))
register_variant("sat+lut+np4+reservoir",
                 VariantSpec("sat", "lut", 4, "reservoir"),
                 aliases=("reservoir",))

#: Canonical registry names in ladder order (Table II rows).
VARIANTS = ("vanilla+cosine", "sat+cosine", "sat+lut",
            "sat+lut+np6", "sat+lut+np4", "sat+lut+np2")

#: Sampler variants of the np4 student (registry names).
SAMPLER_VARIANTS = ("sat+lut+np4", "sat+lut+np4+uniform",
                    "sat+lut+np4+reservoir")


def resolve_variant(spec) -> VariantSpec:
    """A canonical name, an alias, a ``<attention>+<encoder>[+np<k>]
    [+<sampler>]`` string, a VariantSpec or a TGNConfig."""
    if isinstance(spec, VariantSpec):
        return spec
    if isinstance(spec, tgn.TGNConfig):
        return VariantSpec(spec.attention, spec.encoder, spec.prune_k,
                           spec.sampler)
    if not isinstance(spec, str):
        raise TypeError(f"cannot resolve variant from {type(spec)!r}")
    name = _ALIASES.get(spec, spec)
    if name in _REGISTRY:
        return _REGISTRY[name]
    return _parse_spec(spec)


def _parse_spec(spec: str) -> VariantSpec:
    """Grammar fallback: ``<attention>+<encoder>[+np<k>][+<sampler>]``."""
    parts = spec.split("+")
    if len(parts) not in (2, 3, 4):
        raise ValueError(f"unknown variant {spec!r}; {spec_menu()}")
    attention, encoder = parts[0], parts[1]
    if attention not in ("vanilla", "sat"):
        raise ValueError(f"unknown attention {attention!r} in {spec!r}; "
                         f"{spec_menu()}")
    if encoder not in ("cosine", "lut"):
        raise ValueError(f"unknown encoder {encoder!r} in {spec!r}; "
                         f"{spec_menu()}")
    if attention == "vanilla" and encoder != "cosine":
        raise ValueError("vanilla attention requires the cosine encoder "
                         "(its K/Q/V inputs consume the cosine encoding "
                         "directly; LUT is a SAT-path optimization); got "
                         f"{spec!r}; {spec_menu()}")
    prune_k = None
    sampler = None
    for clause in parts[2:]:
        if clause.startswith("np") and clause[2:].isdigit():
            if prune_k is not None:
                raise ValueError(f"duplicate prune clause {clause!r} in "
                                 f"{spec!r}; {spec_menu()}")
            prune_k = int(clause[2:])
            if attention != "sat":
                raise ValueError("neighbor pruning requires SAT "
                                 f"(prune-then-fetch); got {spec!r}; "
                                 f"{spec_menu()}")
        elif clause in stages.SAMPLERS:
            if sampler is not None:
                raise ValueError(f"duplicate sampler clause {clause!r} in "
                                 f"{spec!r}; {spec_menu()}")
            sampler = clause
            if attention != "sat" and clause != "recent":
                raise ValueError(
                    "alternative sampler backends require SAT "
                    f"(prune-then-fetch); got {spec!r}; {spec_menu()}")
        else:
            raise ValueError(f"bad clause {clause!r} in {spec!r}; "
                             f"{spec_menu()}")
    return VariantSpec(attention, encoder, prune_k,
                       sampler if sampler is not None else "recent")


def variant_name(spec) -> str:
    """The registry name of a spec or config, or its canonical string by
    the grammar where none is registered."""
    v = resolve_variant(spec)
    for name, s in _REGISTRY.items():
        if s == v:
            return name
    base = f"{v.attention}+{v.encoder}"
    if v.prune_k is not None:
        base += f"+np{v.prune_k}"
    if v.sampler != "recent":
        base += f"+{v.sampler}"
    return base


def variant_config(spec, **dims) -> tgn.TGNConfig:
    """TGNConfig for a variant at the given table/feature dims."""
    v = resolve_variant(spec)
    return tgn.TGNConfig(**dims, attention=v.attention, encoder=v.encoder,
                         prune_k=v.prune_k, sampler=v.sampler)


class TGNPipeline:
    """Algorithm 1 as a composition of the resolved stages, on one device.

      prepare(params) -> aux                       derived tables
      step(params, aux, state, batch, edge_feats, node_feats) -> BatchOut
      embed(params, aux, state, edge_feats, node_feats, vids, t) -> (h, ...)
    """

    def __init__(self, cfg: tgn.TGNConfig, use_kernels=False, device=None):
        self.use_kernels = stages.kernel_tier(use_kernels)
        #: the tier that runs (``"fused"`` runs as ``"staged"`` outside the
        #: fused step's coverage)
        self.tier = stages.resolved_tier(cfg, use_kernels)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.variant = variant_name(cfg)
        self.stages = stages.build_stages(cfg, use_kernels)
        self.prepare = stages.make_prepare(cfg, use_kernels)

    def init_params(self, generator: torch.Generator | None = None,
                    dt_samples=None) -> dict:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return tgn.init_params(generator, self.cfg, self.device,
                               dt_samples=dt_samples)

    def init_state(self) -> mailbox.VertexState:
        return tgn.init_state(self.cfg, self.device)

    def step(self, params: dict, aux: dict, state: mailbox.VertexState,
             batch, edge_feats: torch.Tensor,
             node_feats: torch.Tensor | None = None) -> tgn.BatchOut:
        """Process one chronological batch of edges ``(src, dst, eid, ts,
        valid)`` (each (B,); ``valid`` may be None). Commits are
        chronological, last write wins per vertex; padding rows write
        nothing (their embeddings are computed but are garbage the caller
        must mask). ``node_feats`` (n_nodes, f_feat) are the static node
        features, or None. ``state`` is not modified: this is
        ``batched_step`` on a one-tenant copy of its tables."""
        out = self.batched_step(
            params, aux, mailbox.stack_states([state], state),
            tuple(None if x is None else x[None] for x in batch),
            edge_feats, node_feats)
        return tgn.BatchOut(
            state=mailbox.tenant_view(out.state, 0, self.cfg.n_nodes),
            emb_src=out.emb_src[0], emb_dst=out.emb_dst[0],
            attn_logits=out.attn_logits[0], nbr_valid=out.nbr_valid[0],
            nbr_dt=out.nbr_dt[0])

    def batched_step(self, params: dict, aux: dict,
                     tables: mailbox.VertexState, batch,
                     edge_feats: torch.Tensor,
                     node_feats: torch.Tensor | None = None) -> tgn.BatchOut:
        """The cohort step: ``step`` for T tenants at once, each on its own
        state, committed IN PLACE.

        ``tables`` are the cohort's stacked tables (``mailbox.stack_states``:
        T·V + 1 rows, tenant t's vertex v at row t·V + v, one scratch row);
        ``batch`` leaves are (T, B). Rows are tenant-major: tenant t's B
        src rows, then its B dst rows. Vertex ids are offset by t·V, so
        every gather, scatter, top-k and kernel call runs once over the
        T·2B rows; races (last write wins, ring slots) are resolved within
        each tenant's rows, and edge and node features are shared. The
        stages' torch products run on each tenant's rows alone
        (``utils.per_tenant``). Each tenant's results equal ``step`` on
        its own state, bit for bit. Returns a
        BatchOut whose leaves carry the tenant axis ((T, B, f_emb),
        (T, 2B, m_r)) and whose ``state`` is ``tables``."""
        src, dst, eid, ts, valid = batch
        T, B = src.shape
        dev = src.device
        local = torch.cat([src, dst], dim=1)         # (T, 2B) vertex ids
        t_inst = torch.cat([ts, ts], dim=1).reshape(-1)
        vvalid = (torch.cat([valid, valid], dim=1) if valid is not None
                  else torch.ones((T, 2 * B), dtype=torch.bool, device=dev))
        base = None
        vids = local.reshape(-1)                     # (T·2B,) table rows
        if T > 1:
            base = (torch.arange(T, dtype=local.dtype, device=dev)
                    * self.cfg.n_nodes)[:, None].expand(T, 2 * B).reshape(-1)
            vids = vids + base
        st = self.stages
        # chronological last-write-wins, raced within each tenant's rows;
        # the winners serve the memory and the mail commits
        winners = st.committer.winners(local, vvalid, B).reshape(-1)
        rows2 = vids.reshape(T, 2, B).long()         # [:, 0] src, [:, 1] dst

        if st.fused is not None:
            # fused tier: the post-prune datapath is ONE fused_step call (it
            # covers no node features: fused_supported)
            h, s_upd, lu_upd, sel = st.fused(params, aux, tables, vids,
                                             t_inst, winners, edge_feats,
                                             base)
            st.committer.commit_memory(tables, vids, winners, s_upd, lu_upd)
            # the committed memory of a valid row r is exactly s_upd[r]
            # (duplicates of a vertex compute identical updates), so the
            # mail needs no post-commit gather
            s2 = s_upd.reshape(T, 2, B, -1)
            ms, md = s2[:, 0], s2[:, 1]
            logits, nvalid, ndt = sel.full_logits, sel.full_valid, sel.full_dt
        else:
            # 1. UPDT: consume cached mail for involved vertices
            s_upd, lu_upd = st.memory_updater(params, aux, tables, vids,
                                              tenants=T)
            # 2. chronological commit of memory
            st.committer.commit_memory(tables, vids, winners, s_upd, lu_upd)
            # 3. GNN embeddings (sampler + aggregator on updated memory)
            nb = st.sampler(params, aux, tables, edge_feats, vids, t_inst,
                            base)
            s_self = tables.memory[vids.long()]
            f_self = (node_feats[local.reshape(-1).long()]
                      if node_feats is not None else None)
            h, logits = st.aggregator(params, aux, nb, s_self, f_self,
                                      tenants=T)
            nvalid, ndt = nb.full_valid, nb.full_dt
            mem_t = tables.memory
            ms, md = mem_t[rows2[:, 0]], mem_t[rows2[:, 1]]

        # 4. cache new messages (Most-Recent aggregator == LWW commit)
        fe = edge_feats[eid.reshape(T, B).long()]
        new_mail = torch.cat([memory.build_mail_raw(ms, md, fe),
                              memory.build_mail_raw(md, ms, fe)],
                             dim=1).reshape(T * 2 * B, -1)
        st.committer.commit_mail(tables, vids, winners, new_mail, t_inst)

        # 5. neighbor ring-buffer insertion (FIFO sampler)
        mailbox.insert_neighbors_(tables, src, dst, eid, ts, valid)
        h = h.reshape(T, 2 * B, -1)
        return tgn.BatchOut(state=tables, emb_src=h[:, :B], emb_dst=h[:, B:],
                            attn_logits=logits.reshape(T, 2 * B, -1),
                            nbr_valid=nvalid.reshape(T, 2 * B, -1),
                            nbr_dt=ndt.reshape(T, 2 * B, -1))

    def embed(self, params: dict, aux: dict, state: mailbox.VertexState,
              edge_feats: torch.Tensor, node_feats: torch.Tensor | None,
              vids: torch.Tensor, t_query: torch.Tensor):
        """Dynamic embeddings of vertex instances ``vids`` at ``t_query``
        without a state update (negative-destination scoring, ad-hoc
        queries): the sampler and aggregator of ``step``, on the staged
        backends on the fused tier. Returns ``(h, logits, full_valid,
        full_dt)``."""
        nb = self.stages.sampler(params, aux, state, edge_feats, vids,
                                 t_query)
        s_self = state.memory[vids.long()]
        f_self = node_feats[vids.long()] if node_feats is not None else None
        h, logits = self.stages.aggregator(params, aux, nb, s_self, f_self)
        return h, logits, nb.full_valid, nb.full_dt

    def step_fn(self, params: dict, state: mailbox.VertexState, batch,
                edge_feats: torch.Tensor,
                node_feats: torch.Tensor | None = None) -> tgn.BatchOut:
        """``step`` with aux derived from ``params`` on the spot."""
        return self.step(params, self.prepare(params), state, batch,
                         edge_feats, node_feats)

    def describe(self) -> dict:
        """Variant, requested and resolved tier, stage backends."""
        return {"variant": self.variant, "use_kernels": self.use_kernels,
                "tier": self.tier, "device": str(self.device),
                "lane": self.stages.variant_id, **self.stages.names}


class CoalescedRound:
    """One Python call that advances EVERY cohort of a serving round.

    The cohorts' lanes (one a cohort, or one a shard of a cohort on a
    device mesh) are laid out as contiguous row segments of a common
    super-batch (rows = the sum of the lanes' slots, columns = the widest
    batch); each segment is advanced by its lane's step, the
    ``batched_step`` of the pipeline that built it on the lane's
    parameters and tables, so every kernel runs once per lane over the
    stacked rows of all its tenants. The segments' steps are issued back
    to back with no host sync in between.

    The lane table is static: segment i's rows are advanced by
    ``parts[i]``'s program (``stages.variant_id``), a teacher lane and
    student lanes on their own weights in the same round. Each segment
    keeps its own width (its cohort's widest batch this round, the width
    its per-cohort launch would take), so a tenant's rows see the same
    shapes as when its cohort launches alone. Pad rows (idle tenants,
    spare slots, batch-width padding) are ``valid=False``: the
    last-write-wins commits and the ring insert send their writes to the
    scratch row, so they change no tenant's state. ``edges``, the round's
    count of valid edges, is summed on the device and left pending.

    ``calls`` counts rounds issued through this layout; ``traces`` counts
    layout builds: 1 for the life of this object, so a live admission into
    a spare slot, which reuses it, leaves it unchanged. ``obs`` (a
    ``MetricsRegistry``) mirrors both into the ``compile.round_traces`` /
    ``compile.round_calls`` gauges.
    """

    def __init__(self, parts, *, obs=None):
        """``parts``: ``(pipeline, step, rows)`` a lane: ``step(batch)``
        advances the lane's ``rows`` tenant slots in place and returns
        their BatchOut."""
        self.parts = tuple((p, step, int(r)) for p, step, r in parts)
        segments, lo = [], 0
        for _pipe, _step, rows in self.parts:
            segments.append((lo, lo + rows))
            lo += rows
        self.segments = tuple(segments)
        self.rows = lo
        self.calls = 0
        self.traces = 1
        self._g_calls = None
        if obs is not None:
            obs.gauge("compile.round_traces").set(self.traces)
            self._g_calls = obs.gauge("compile.round_calls")
            self._g_calls.set(0)

    def __call__(self, superbatch: tuple, *, widths: tuple | None = None):
        """``superbatch``: (rows, width) src, dst, eid, ts, valid.
        Returns ``(outs, edges)``: a ``batched_step`` BatchOut a lane,
        and the round's valid-edge count as a device scalar."""
        if widths is None:
            widths = (superbatch[0].shape[1],) * len(self.parts)
        self.calls += 1
        if self._g_calls is not None:
            self._g_calls.set(self.calls)
        outs = tuple(step(tuple(x[lo:hi, :w] for x in superbatch))
                     for (lo, hi), (_p, step, _r), w in zip(
                         self.segments, self.parts, widths))
        return outs, superbatch[4].sum()


def build_pipeline(spec, use_kernels=False, device=None,
                   **dims) -> TGNPipeline:
    """Build the pipeline for a variant. ``spec`` is a TGNConfig (``dims``
    must then be empty) or a variant string whose ``dims`` fill in the
    TGNConfig table/feature fields. As in the reference, the pipeline is
    built for the RESOLVED tier: ``"fused"`` on a variant outside the
    fused step's coverage is the staged pipeline."""
    if isinstance(spec, tgn.TGNConfig):
        if dims:
            raise TypeError("dims are only valid with a variant spec, "
                            "not a full TGNConfig")
        cfg = spec
    else:
        cfg = variant_config(spec, **dims)
    return TGNPipeline(cfg, stages.resolved_tier(cfg, use_kernels),
                       device=device)
