"""The TGN pipeline: Algorithm 1 as one composition of the stages, for
every variant of the paper's ladder (Table II):

    vanilla+cosine  ->  sat+cosine  ->  sat+lut  ->  sat+lut+np{6,4,2}

Port of ``repro.core.pipeline``:

    pipe = build_pipeline("sat+lut+np4", n_nodes=..., n_edges=...)
    aux  = pipe.prepare(params)                  # folded/packed tables
    out  = pipe.step(params, aux, state, batch, edge_feats)   # BatchOut
    h, logits, valid, dt = pipe.embed(params, aux, state, edge_feats,
                                      None, vids, t_query)

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
        features, or None."""
        src, dst, eid, ts, valid = batch
        B = src.shape[0]
        vids = torch.cat([src, dst])                 # (2B,) involved instances
        t_inst = torch.cat([ts, ts])
        vvalid = (torch.cat([valid, valid]) if valid is not None
                  else torch.ones((2 * B,), dtype=torch.bool,
                                  device=src.device))
        st = self.stages

        # fused tier: the post-prune datapath is ONE fused_step call (it
        # covers no node features: fused_supported)
        if st.fused is not None:
            return st.fused(params, aux, state, batch, vids, t_inst, vvalid,
                            edge_feats)

        # 1. UPDT: consume cached mail for involved vertices
        s_upd, lu_upd = st.memory_updater(params, aux, state, vids)

        # 2. chronological commit of memory (winners computed ONCE)
        winners = st.committer.winners(vids, vvalid, B)
        state = st.committer.commit_memory(state, vids, winners, s_upd,
                                           lu_upd)

        # 3. GNN embeddings (sampler + aggregator on updated memory)
        nb = st.sampler(params, aux, state, edge_feats, vids, t_inst)
        s_self = state.memory[vids.long()]
        f_self = node_feats[vids.long()] if node_feats is not None else None
        h, logits = st.aggregator(params, aux, nb, s_self, f_self)

        # 4. cache new messages (Most-Recent aggregator == LWW commit)
        mem_t = state.memory
        fe = edge_feats[eid.long()]
        ms, md = mem_t[src.long()], mem_t[dst.long()]
        new_mail = torch.cat([memory.build_mail_raw(ms, md, fe),
                              memory.build_mail_raw(md, ms, fe)])
        state = st.committer.commit_mail(state, vids, winners, new_mail,
                                         t_inst)

        # 5. neighbor ring-buffer insertion (FIFO sampler)
        state = mailbox.insert_neighbors(state, src, dst, eid, ts, valid)

        return tgn.BatchOut(state=state, emb_src=h[:B], emb_dst=h[B:],
                            attn_logits=logits, nbr_valid=nb.full_valid,
                            nbr_dt=nb.full_dt)

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
                **self.stages.names}


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
