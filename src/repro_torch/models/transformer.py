"""Decoder-only LM family: dense GQA transformers and MoE transformers, the
port of ``repro.models.transformer``: init, the training loss, prefill and
decode.

Covers gemma3-12b (5:1 local:global sliding-window pattern, RoPE-scaled
globals), mistral-nemo-12b, granite-3-8b, qwen3-8b (qk-norm), dbrx-132b
(16e top-4) and grok-1-314b (8e top-2).

Layers are grouped into blocks of ``len(cfg.pattern)`` layers; the
per-block parameter trees and caches are stacked along a leading axis, as
in the reference. The forward loops over the blocks through views of the
stacked leaves, and decode writes each block's new keys and values into
the stacked caches in place (the reference's ``decode_unroll`` form; its
scanned form computes the same). Each block body runs under ``_remat``
(the reference's ``jax.checkpoint`` of the scan body, policy ``remat``).
The activation constraints sit where the reference's do
(``sharding.constrain``: the identity on one device).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.obs import optrace
from repro_torch.utils import FrozenConfig


@dataclasses.dataclass(frozen=True)
class LMConfig(FrozenConfig):
    arch: str = "lm"
    n_layers: int = 12
    d_model: int = 512
    n_heads: int = 8
    n_kv_heads: int = 8
    d_head: int = 64
    d_ff: int = 2048
    vocab: int = 32_000
    rope_theta: float = 10_000.0
    rope_theta_local: float | None = None   # gemma3 locals use theta=10k
    rope_scaling: float = 1.0               # gemma3 globals: 8x linear scale
    qk_norm: bool = False
    window: int | None = None               # sliding-window width for "local"
    pattern: tuple[str, ...] = ("global",)  # repeating layer kinds
    softcap: float | None = None
    act: str = "silu"
    embed_scale: bool = False               # gemma multiplies embed by sqrt(d)
    # MoE (0 experts = dense)
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # execution
    dtype: str = "bfloat16"
    remat: str = "nothing"                  # "nothing" | "dots" | "none"
    attn_remat: bool = False                # §Perf H1: flash-style bwd remat
    decode_upcast: bool = True              # §Perf O4 off = no fp32 cache copy
    kv_prune_keep: int = 0                  # §Perf O2: >0 = positional KV prune
    decode_unroll: bool = False             # §Perf O5; the port always loops
    q_block: int = 512
    k_block: int = 1024
    loss_chunk: int = 512

    @property
    def n_blocks(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, \
            (self.arch, self.n_layers, self.pattern)
        return self.n_layers // len(self.pattern)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def attn_cfg(self, kind: str) -> L.AttnCfg:
        local = kind == "local"
        theta = (self.rope_theta_local if (local and self.rope_theta_local)
                 else self.rope_theta)
        return L.AttnCfg(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, d_head=self.d_head,
            rope_theta=theta,
            rope_scaling=1.0 if local else self.rope_scaling,
            qk_norm=self.qk_norm,
            window=self.window if local else None,
            softcap=self.softcap, cache_upcast=self.decode_upcast)

    @property
    def n_params(self) -> int:
        """Total parameter count (embedding + blocks + head)."""
        d, f = self.d_model, self.d_ff
        attn = d * self.n_heads * self.d_head * 2 \
            + d * self.n_kv_heads * self.d_head * 2
        if self.n_experts:
            ffn = self.n_experts * 3 * d * f + d * self.n_experts
        else:
            ffn = 3 * d * f
        per_layer = attn + ffn + 2 * d
        return self.vocab * d * 2 + self.n_layers * per_layer + d

    @property
    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.n_params
        d, f = self.d_model, self.d_ff
        attn = d * self.n_heads * self.d_head * 2 \
            + d * self.n_kv_heads * self.d_head * 2
        ffn = self.top_k * 3 * d * f + d * self.n_experts
        per_layer = attn + ffn + 2 * d
        return self.vocab * d * 2 + self.n_layers * per_layer + d


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_layer(generator: torch.Generator, cfg: LMConfig, kind: str,
                device, stack: tuple) -> dict:
    p = {
        "ln1": L.init_rmsnorm(cfg.d_model, device, stack),
        "attn": L.init_attention(generator, cfg.attn_cfg(kind), device, stack),
        "ln2": L.init_rmsnorm(cfg.d_model, device, stack),
    }
    if cfg.n_experts:
        p["moe"] = M.init_moe(generator, cfg.d_model, cfg.d_ff,
                              cfg.n_experts, device, stack)
    else:
        p["mlp"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff, device,
                              stack=stack)
    return p


def init(generator: torch.Generator, cfg: LMConfig, device) -> dict:
    """Stacked params: blocks.l{i}.* leaves have leading dim n_blocks.
    Drawn leaf by leaf on ``generator``'s device, then moved to
    ``device``."""
    stack = (cfg.n_blocks,)
    return {
        "embed": L.init_embed(generator, cfg.vocab, cfg.d_model, device),
        "blocks": {f"l{i}": _init_layer(generator, cfg, kind, device, stack)
                   for i, kind in enumerate(cfg.pattern)},
        "final_norm": L.init_rmsnorm(cfg.d_model, device),
        "head": L.init_unembed(generator, cfg.d_model, cfg.vocab, device),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _ffn(lp: dict, cfg: LMConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.n_experts:
        B, S, D = h.shape
        y = M.moe_ffn(lp["moe"], h.reshape(B * S, D), cfg.top_k,
                      capacity_factor=cfg.capacity_factor, act=cfg.act)
        return y.reshape(B, S, D)
    return L.mlp(lp["mlp"], h, act=cfg.act)


def _layer_fwd(lp: dict, cfg: LMConfig, kind: str, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(lp["ln1"], x)
    x = x + L.chunked_attention(lp["attn"], cfg.attn_cfg(kind), h, positions,
                                q_block=cfg.q_block, k_block=cfg.k_block,
                                remat_qblocks=cfg.attn_remat)
    return x + _ffn(lp, cfg, L.rmsnorm(lp["ln2"], x))


def _block_fwd(bp: dict, cfg: LMConfig, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    x = shd.constrain(x, "block_in")
    for i, kind in enumerate(cfg.pattern):
        x = _layer_fwd(bp[f"l{i}"], cfg, kind, x, positions)
    return x


def _remat(fn, cfg: LMConfig):
    """``fn`` under the config's remat policy: ``"nothing"`` saves only a
    block's input, ``"dots"`` also its products, ``"none"`` everything."""
    return L.remat(fn, cfg.remat)


def _embed(params: dict, cfg: LMConfig, tokens: torch.Tensor
           ) -> torch.Tensor:
    x = L.embed(params["embed"], tokens, cfg.compute_dtype)
    if cfg.embed_scale:
        # sqrt(d) rounded to the compute dtype first, as jnp.asarray does
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype))
    return x


def backbone(params: dict, cfg: LMConfig, tokens: torch.Tensor,
             positions: torch.Tensor | None = None) -> torch.Tensor:
    """tokens (B, S) -> final hidden states (B, S, D)."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = _embed(params, cfg, tokens)
    body = _remat(_block_fwd, cfg)
    x = shd.constrain(x, "carry")
    for b in optrace.trips("blocks", cfg.n_blocks):
        x = shd.constrain(
            body(L.block_view(params["blocks"], b), cfg, x, positions),
            "carry")
    return L.rmsnorm(params["final_norm"], x)


def loss_fn(params: dict, cfg: LMConfig, tokens: torch.Tensor,
            targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy, vocab-chunk-safe: the loss runs over
    sequence chunks, each chunk's fp32 logits recomputed in the backward,
    so the (B, S, V) logits never fully materialize."""
    h = backbone(params, cfg, tokens)
    assert h.shape[1] % min(cfg.loss_chunk, h.shape[1]) == 0
    return L.chunked_xent(h, params["head"]["unembed"], targets,
                          cfg.loss_chunk)


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode
# ---------------------------------------------------------------------------


def init_caches(cfg: LMConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, *, device) -> dict:
    """Stacked caches: one entry per pattern position, leading dim n_blocks.
    Local layers get O(window) ring caches, globals full-length caches."""
    def one(kind):
        acfg = cfg.attn_cfg(kind)
        if kind == "local" and cfg.window is not None and cfg.window < max_len:
            return L.init_ring_cache(batch, cfg.window, acfg, dtype,
                                     device=device, stack=(cfg.n_blocks,))
        return L.init_kv_cache(batch, max_len, acfg, dtype, device=device,
                               stack=(cfg.n_blocks,))

    return {f"l{i}": one(kind) for i, kind in enumerate(cfg.pattern)}


def decode_step(params: dict, cfg: LMConfig, token: torch.Tensor,
                caches: dict):
    """token (B, 1) int32; caches from init_caches (all at the same pos),
    updated in place. Returns (logits (B, vocab) fp32, caches)."""
    x = _embed(params, cfg, token)
    for b in optrace.trips("blocks", cfg.n_blocks):
        bp = L.block_view(params["blocks"], b)
        for i, kind in enumerate(cfg.pattern):
            lp, c = bp[f"l{i}"], L.block_view(caches[f"l{i}"], b)
            h = L.rmsnorm(lp["ln1"], x)
            # §Perf O2: positional KV pruning on full (non-ring) caches —
            # the paper's SAT prune-before-fetch at the decode KV cache
            if cfg.kv_prune_keep and "k_pos" not in c \
                    and c["k"].shape[1] > cfg.kv_prune_keep:
                a, _ = L.pruned_decode_attention(
                    lp["attn"], cfg.attn_cfg(kind), h, c, cfg.kv_prune_keep)
            else:
                a, _ = L.decode_attention(lp["attn"], cfg.attn_cfg(kind), h,
                                          c)
            x = x + a
            x = x + _ffn(lp, cfg, L.rmsnorm(lp["ln2"], x))
    h = L.rmsnorm(params["final_norm"], x)
    return L.unembed(params["head"], h)[:, 0], caches


def prefill(params: dict, cfg: LMConfig, tokens: torch.Tensor):
    """Prompt pass: returns (last-token logits (B, vocab) fp32, hidden
    states)."""
    h = backbone(params, cfg, tokens)
    return L.unembed(params["head"], h[:, -1:])[:, 0], h
