"""Llama-3.2-Vision-style backbone: text decoder with gated cross-attention
image layers every 5th layer (vision frontend stubbed), the port of
``repro.models.vision_lm``.

Only the transformer BACKBONE is modeled: the caller provides precomputed
patch embeddings (B, n_patches, D). Self layers are llama-3.1 GQA + SwiGLU;
cross layers attend from text to image tokens with tanh-gated residuals
(zero-initialized gates, so the text path is intact at init).

Pattern per block: 4 self + 1 cross (40 layers = 8 blocks).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.models import layers as L
from repro_torch.obs import optrace
from repro_torch.utils import FrozenConfig


@dataclasses.dataclass(frozen=True)
class VisionLMConfig(FrozenConfig):
    arch: str = "llama32-vision"
    n_layers: int = 40
    d_model: int = 4096
    n_heads: int = 32
    n_kv_heads: int = 8
    d_head: int = 128
    d_ff: int = 14_336
    vocab: int = 128_256
    n_patches: int = 1024        # stubbed vision tokens per sample
    rope_theta: float = 500_000.0
    cross_every: int = 5         # every 5th layer is cross-attention
    dtype: str = "bfloat16"
    remat: str = "nothing"
    q_block: int = 512
    k_block: int = 1024
    loss_chunk: int = 512

    @property
    def pattern(self) -> tuple[str, ...]:
        return ("self",) * (self.cross_every - 1) + ("cross",)

    @property
    def n_blocks(self) -> int:
        assert self.n_layers % self.cross_every == 0
        return self.n_layers // self.cross_every

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def attn_cfg(self) -> L.AttnCfg:
        return L.AttnCfg(d_model=self.d_model, n_heads=self.n_heads,
                         n_kv_heads=self.n_kv_heads, d_head=self.d_head,
                         rope_theta=self.rope_theta)

    def xattn_cfg(self) -> L.AttnCfg:
        return L.AttnCfg(d_model=self.d_model, n_heads=self.n_heads,
                         n_kv_heads=self.n_kv_heads, d_head=self.d_head,
                         use_rope=False, qk_norm=True)

    @property
    def n_params(self) -> int:
        d, f = self.d_model, self.d_ff
        attn = d * self.n_heads * self.d_head * 2 \
            + d * self.n_kv_heads * self.d_head * 2
        per_layer = attn + 3 * d * f + 2 * d
        return self.vocab * d * 2 + self.n_layers * per_layer + d

    n_active_params = n_params


def _init_layer(generator: torch.Generator, cfg: VisionLMConfig, kind: str,
                device, st: tuple) -> dict:
    p = {"ln1": L.init_rmsnorm(cfg.d_model, device, st),
         "ln2": L.init_rmsnorm(cfg.d_model, device, st),
         "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, device,
                           stack=st)}
    if kind == "self":
        p["attn"] = L.init_attention(generator, cfg.attn_cfg(), device, st)
    else:
        p["xattn"] = L.init_attention(generator, cfg.xattn_cfg(), device, st)
        p["gate_attn"] = L.zeros((), device, st)
        p["gate_ffn"] = L.zeros((), device, st)
    return p


def init(generator: torch.Generator, cfg: VisionLMConfig, device) -> dict:
    """Stacked params: blocks.l{i}.* leaves have leading dim n_blocks."""
    st = (cfg.n_blocks,)
    return {
        "embed": L.init_embed(generator, cfg.vocab, cfg.d_model, device),
        "blocks": {f"l{i}": _init_layer(generator, cfg, kind, device, st)
                   for i, kind in enumerate(cfg.pattern)},
        "final_norm": L.init_rmsnorm(cfg.d_model, device),
        "head": L.init_unembed(generator, cfg.d_model, cfg.vocab, device),
    }


def _layer_fwd(lp: dict, cfg: VisionLMConfig, kind: str, x: torch.Tensor,
               positions: torch.Tensor, vision: torch.Tensor
               ) -> torch.Tensor:
    h = L.rmsnorm(lp["ln1"], x)
    if kind == "self":
        a = L.chunked_attention(lp["attn"], cfg.attn_cfg(), h, positions,
                                q_block=cfg.q_block, k_block=cfg.k_block)
        x = x + a
        h = L.rmsnorm(lp["ln2"], x)
        return x + L.mlp(lp["mlp"], h)
    vis_pos = torch.arange(vision.shape[1], dtype=torch.int32,
                           device=x.device)
    a = L.chunked_attention(lp["xattn"], cfg.xattn_cfg(), h, positions,
                            kv_x=vision.to(h.dtype), kv_positions=vis_pos,
                            causal=False, q_block=cfg.q_block,
                            k_block=cfg.k_block)
    x = x + torch.tanh(lp["gate_attn"]).to(x.dtype) * a
    h = L.rmsnorm(lp["ln2"], x)
    return x + torch.tanh(lp["gate_ffn"]).to(x.dtype) * L.mlp(lp["mlp"], h)


def backbone(params: dict, cfg: VisionLMConfig, tokens: torch.Tensor,
             vision: torch.Tensor) -> torch.Tensor:
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = L.embed(params["embed"], tokens, cfg.compute_dtype)

    def body(bp, x):
        for i, kind in enumerate(cfg.pattern):
            x = _layer_fwd(bp[f"l{i}"], cfg, kind, x, positions, vision)
        return x

    body = L.block_remat(body, cfg)
    x = shd.constrain(x, "carry")
    for b in optrace.trips("blocks", cfg.n_blocks):
        x = shd.constrain(body(L.block_view(params["blocks"], b), x),
                          "carry")
    return L.rmsnorm(params["final_norm"], x)


def loss_fn(params: dict, cfg: VisionLMConfig, tokens: torch.Tensor,
            vision: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    h = backbone(params, cfg, tokens, vision)
    return L.chunked_xent(h, params["head"]["unembed"], targets,
                          cfg.loss_chunk)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def init_caches(cfg: VisionLMConfig, batch: int, max_len: int,
                params: dict | None = None,
                vision: torch.Tensor | None = None,
                dtype=torch.bfloat16, *, device=None) -> dict:
    """Self-KV caches per block + fixed cross K/V from the vision tokens
    (zeros without them). ``device`` defaults to ``vision``'s."""
    if device is None:
        device = vision.device
    nb = cfg.n_blocks
    caches = {f"l{i}": L.init_kv_cache(batch, max_len, cfg.attn_cfg(), dtype,
                                       device=device, stack=(nb,))
              for i, kind in enumerate(cfg.pattern) if kind == "self"}
    kv, hd = cfg.n_kv_heads, cfg.d_head
    ci = len(cfg.pattern) - 1  # cross position
    if params is not None and vision is not None:
        S = vision.shape[1]
        dt = vision.dtype
        ks, vs = [], []
        for b in range(nb):  # one block's cross K/V at a time
            xp = L.block_view(params["blocks"], b)[f"l{ci}"]["xattn"]
            k = (vision @ xp["wk"].to(dt)).reshape(batch, S, kv, hd)
            k = L.rmsnorm(xp["k_norm"], k)
            v = (vision @ xp["wv"].to(dt)).reshape(batch, S, kv, hd)
            ks.append(k.to(dtype))
            vs.append(v.to(dtype))
        ck, cv = torch.stack(ks), torch.stack(vs)
    else:
        ck = torch.zeros((nb, batch, cfg.n_patches, kv, hd), dtype=dtype,
                         device=device)
        cv = torch.zeros_like(ck)
    caches["cross_k"], caches["cross_v"] = ck, cv
    return caches


def decode_step(params: dict, cfg: VisionLMConfig, token: torch.Tensor,
                caches: dict):
    """One token; the self caches are updated in place. Returns (logits
    (B, vocab) fp32, caches)."""
    B = token.shape[0]
    x = L.embed(params["embed"], token, cfg.compute_dtype)
    kvh, hd = cfg.n_kv_heads, cfg.d_head
    for b in optrace.trips("blocks", cfg.n_blocks):
        bp = L.block_view(params["blocks"], b)
        for i, kind in enumerate(cfg.pattern):
            lp = bp[f"l{i}"]
            h = L.rmsnorm(lp["ln1"], x)
            if kind == "self":
                a, _ = L.decode_attention(
                    lp["attn"], cfg.attn_cfg(), h,
                    L.block_view(caches[f"l{i}"], b))
                x = x + a
                h = L.rmsnorm(lp["ln2"], x)
                x = x + L.mlp(lp["mlp"], h)
            else:
                dt = h.dtype
                xp = lp["xattn"]
                q = (h @ xp["wq"].to(dt)).reshape(B, kvh,
                                                  cfg.n_heads // kvh, hd)
                q = L.rmsnorm(xp["q_norm"], q)
                s = torch.einsum("bngd,btnd->bngt", q.float(),
                                 caches["cross_k"][b].float()) / math.sqrt(hd)
                attn = torch.softmax(s, dim=-1)
                o = torch.einsum("bngt,btnd->bngd", attn,
                                 caches["cross_v"][b].float())
                o = o.reshape(B, 1, cfg.n_heads * hd).to(dt)
                a = o @ xp["wo"].to(dt)
                x = x + torch.tanh(lp["gate_attn"]).to(dt) * a
                h = L.rmsnorm(lp["ln2"], x)
                x = x + torch.tanh(lp["gate_ffn"]).to(dt) * L.mlp(
                    lp["mlp"], h)
    h = L.rmsnorm(params["final_norm"], x)
    return L.unembed(params["head"], h)[:, 0], caches


def prefill(params: dict, cfg: VisionLMConfig, tokens: torch.Tensor,
            vision: torch.Tensor):
    h = backbone(params, cfg, tokens, vision)
    return L.unembed(params["head"], h[:, -1:])[:, 0], h
