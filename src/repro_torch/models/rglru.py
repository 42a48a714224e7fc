"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks + local
attention, the port of ``repro.models.rglru``.

Layer pattern is (rec, rec, attn) repeating (1 attention : 2 recurrent), with
MQA sliding-window attention (window 2048). 38 layers = 12 stacked triples +
a 2-layer recurrent tail.

RG-LRU (arXiv:2402.19427):
    r_t = sigmoid(W_a x_t + b_a)                  (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)                  (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t),  c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The reference evaluates the training and prefill recurrence with
``lax.associative_scan``; torch has no public equivalent, so ``rglru_scan``
runs it as a sequential fp32 loop over the sequence. The two associate the
products in another order, so they agree to fp32 rounding, not bit for
bit. Autograd differentiates the loop exactly, a step at a time, so its
backward is slow at long sequences. Decode is the O(1) elementwise step.
Gate matrices are block-diagonal (n_heads blocks).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as shd
from repro_torch.models import layers as L
from repro_torch.models.layers import dense_init
from repro_torch.models.mamba2 import _causal_conv  # shared depthwise conv
from repro_torch.obs import optrace
from repro_torch.utils import FrozenConfig

C_RGLRU = 8.0


@dataclasses.dataclass(frozen=True)
class GriffinConfig(FrozenConfig):
    arch: str = "recurrentgemma"
    n_layers: int = 38
    d_model: int = 4096
    lru_width: int = 4096
    n_heads: int = 16           # attention heads; also gate blocks
    n_kv_heads: int = 1
    d_head: int = 256
    d_ff: int = 12288
    vocab: int = 256_000
    window: int = 2048
    rope_theta: float = 10_000.0
    pattern: tuple[str, ...] = ("rec", "rec", "attn")
    dtype: str = "bfloat16"
    remat: str = "nothing"
    q_block: int = 512
    k_block: int = 1024
    loss_chunk: int = 512

    @property
    def n_full_blocks(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def tail(self) -> tuple[str, ...]:
        r = self.n_layers % len(self.pattern)
        return self.pattern[:r]

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def attn_cfg(self) -> L.AttnCfg:
        return L.AttnCfg(d_model=self.d_model, n_heads=self.n_heads,
                         n_kv_heads=self.n_kv_heads, d_head=self.d_head,
                         rope_theta=self.rope_theta, window=self.window)

    @property
    def n_params(self) -> int:
        d, w, f = self.d_model, self.lru_width, self.d_ff
        n_rec = sum(k == "rec" for k in
                    self.pattern * self.n_full_blocks + self.tail)
        n_att = self.n_layers - n_rec
        gate = 2 * self.n_heads * (w // self.n_heads) ** 2
        rec = 2 * d * w + 4 * w + gate + w + w * d
        att = d * self.n_heads * self.d_head * 2 \
            + d * self.n_kv_heads * self.d_head * 2
        mlp = 3 * d * f
        return (self.vocab * d * 2 + n_rec * rec + n_att * att
                + self.n_layers * (mlp + 2 * d) + d)

    n_active_params = n_params


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def init_rglru(generator: torch.Generator, w: int, n_blocks: int, device,
               stack: tuple = ()) -> dict:
    bw = w // n_blocks
    lam = torch.linspace(-2.0, 1.0, w, dtype=torch.float32).to(device)
    return {
        "w_a": dense_init(generator, (n_blocks, bw, bw), device, stack=stack),
        "b_a": L.zeros((w,), device, stack),
        "w_x": dense_init(generator, (n_blocks, bw, bw), device, stack=stack),
        "b_x": L.zeros((w,), device, stack),
        # softplus(lambda) in ~(0.1, 1) -> per-step decay a in (0.45, 0.92)^r
        "lam": lam.expand(*stack, w).contiguous(),
    }


def _block_diag(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., W) @ block-diagonal weight (H, W/H, W/H)."""
    H, bw, _ = w.shape
    xs = x.reshape(*x.shape[:-1], H, bw)
    return torch.einsum("...hi,hij->...hj", xs, w.to(x.dtype)).reshape(
        *x.shape[:-1], H * bw)


def _gates(p: dict, xf: torch.Tensor) -> tuple:
    """(a, sqrt(1 - a^2) * (i * x)) of the recurrence, fp32."""
    r = torch.sigmoid(_block_diag(xf, p["w_a"]) + p["b_a"])
    i = torch.sigmoid(_block_diag(xf, p["w_x"]) + p["b_x"])
    log_a = -C_RGLRU * F.softplus(p["lam"]) * r          # <= 0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * xf)
    return a, b


def rglru_scan(p: dict, x: torch.Tensor, h0: torch.Tensor | None = None):
    """x (B, L, W) -> (y (B, L, W), h_last (B, W)). fp32 recurrence, a
    sequential loop over L (see the module docstring)."""
    a, b = _gates(p, x.float())
    h = (torch.zeros_like(b[:, 0]) if h0 is None else h0.float())
    hs = []
    for t in optrace.trips("rglru_time", x.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    hs = torch.stack(optrace.fill(hs, x.shape[1]), dim=1)
    return hs.to(x.dtype), hs[:, -1]


def rglru_step(p: dict, x: torch.Tensor, h: torch.Tensor):
    """Single decode step: x (B, 1, W), h (B, W) -> (y (B,1,W), h_new)."""
    xf = x[:, 0].float()
    r = torch.sigmoid(_block_diag(xf, p["w_a"]) + p["b_a"])
    i = torch.sigmoid(_block_diag(xf, p["w_x"]) + p["b_x"])
    log_a = -C_RGLRU * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    h_new = a * h.float() \
        + torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * xf)
    return h_new.to(x.dtype)[:, None], h_new


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _init_layer(generator: torch.Generator, cfg: GriffinConfig, kind: str,
                device, stack: tuple) -> dict:
    p = {"ln1": L.init_rmsnorm(cfg.d_model, device, stack),
         "ln2": L.init_rmsnorm(cfg.d_model, device, stack),
         "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, device,
                           stack=stack)}
    if kind == "rec":
        w = cfg.lru_width
        # the reference draws w_gate_in and w_out from one key (at d_model
        # == lru_width they hold the same numbers); the port draws each
        # leaf on its own
        p["rec"] = {
            "w_gate_in": dense_init(generator, (cfg.d_model, w), device,
                                    stack=stack),
            "w_main_in": dense_init(generator, (cfg.d_model, w), device,
                                    stack=stack),
            "conv_w": dense_init(generator, (4, w), device, scale=0.5,
                                 stack=stack),
            "conv_b": L.zeros((w,), device, stack),
            "lru": init_rglru(generator, w, cfg.n_heads, device, stack),
            "w_out": dense_init(generator, (w, cfg.d_model), device,
                                stack=stack),
        }
    else:
        p["attn"] = L.init_attention(generator, cfg.attn_cfg(), device, stack)
    return p


def init(generator: torch.Generator, cfg: GriffinConfig, device) -> dict:
    """Stacked params: blocks.l{i}.* leaves have leading dim n_full_blocks;
    the tail's layers are unstacked."""
    st = (cfg.n_full_blocks,)
    p = {
        "embed": L.init_embed(generator, cfg.vocab, cfg.d_model, device),
        "blocks": {f"l{i}": _init_layer(generator, cfg, kind, device, st)
                   for i, kind in enumerate(cfg.pattern)},
        "final_norm": L.init_rmsnorm(cfg.d_model, device),
        "head": L.init_unembed(generator, cfg.d_model, cfg.vocab, device),
    }
    if cfg.tail:
        p["tail"] = {f"l{i}": _init_layer(generator, cfg, kind, device, ())
                     for i, kind in enumerate(cfg.tail)}
    return p


def _embed(params: dict, cfg: GriffinConfig, tokens: torch.Tensor
           ) -> torch.Tensor:
    x = L.embed(params["embed"], tokens, cfg.compute_dtype)
    # sqrt(d) rounded to the compute dtype first, as jnp.asarray does
    return x * float(torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype))


def _layer_fwd(lp: dict, cfg: GriffinConfig, kind: str, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = L.rmsnorm(lp["ln1"], x)
    if kind == "rec":
        rp = lp["rec"]
        gate = L.gelu(h @ rp["w_gate_in"].to(dt))
        main = h @ rp["w_main_in"].to(dt)
        main, _ = _causal_conv(main, rp["conv_w"], rp["conv_b"])
        main, _ = rglru_scan(rp["lru"], main)
        t_out = (gate * main) @ rp["w_out"].to(dt)
    else:
        t_out = L.chunked_attention(lp["attn"], cfg.attn_cfg(), h, positions,
                                    q_block=cfg.q_block, k_block=cfg.k_block)
    x = x + t_out
    h = L.rmsnorm(lp["ln2"], x)
    return x + L.mlp(lp["mlp"], h, act="gelu")


def backbone(params: dict, cfg: GriffinConfig, tokens: torch.Tensor
             ) -> torch.Tensor:
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = _embed(params, cfg, tokens)

    def body(bp, x):
        for i, kind in enumerate(cfg.pattern):
            x = _layer_fwd(bp[f"l{i}"], cfg, kind, x, positions)
        return x

    # the reference checkpoints the scanned blocks, not the tail
    body = L.block_remat(body, cfg)
    x = shd.constrain(x, "carry")
    for b in optrace.trips("blocks", cfg.n_full_blocks):
        x = shd.constrain(body(L.block_view(params["blocks"], b), x),
                          "carry")
    for i, kind in enumerate(cfg.tail):
        x = _layer_fwd(params["tail"][f"l{i}"], cfg, kind, x, positions)
    return L.rmsnorm(params["final_norm"], x)


def loss_fn(params: dict, cfg: GriffinConfig, tokens: torch.Tensor,
            targets: torch.Tensor) -> torch.Tensor:
    h = backbone(params, cfg, tokens)
    return L.chunked_xent(h, params["head"]["unembed"], targets,
                          cfg.loss_chunk)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _layer_cache(cfg: GriffinConfig, kind: str, batch: int, dtype, device,
                 stack: tuple) -> dict:
    if kind == "rec":
        return {"conv": torch.zeros(stack + (batch, 3, cfg.lru_width),
                                    dtype=dtype, device=device),
                "h": torch.zeros(stack + (batch, cfg.lru_width),
                                 dtype=torch.float32, device=device)}
    return L.init_ring_cache(batch, cfg.window, cfg.attn_cfg(), dtype,
                             device=device, stack=stack)


def init_caches(cfg: GriffinConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, *, device) -> dict:
    del max_len  # bounded state: ring window + O(1) recurrences
    caches = {f"l{i}": _layer_cache(cfg, kind, batch, dtype, device,
                                    (cfg.n_full_blocks,))
              for i, kind in enumerate(cfg.pattern)}
    caches["tail"] = {f"l{i}": _layer_cache(cfg, kind, batch, dtype, device,
                                            ())
                      for i, kind in enumerate(cfg.tail)}
    return caches


def _layer_decode(lp: dict, cfg: GriffinConfig, kind: str, x: torch.Tensor,
                  cache: dict) -> torch.Tensor:
    """One layer's decode; ``cache`` (views) is updated in place."""
    dt = x.dtype
    h = L.rmsnorm(lp["ln1"], x)
    if kind == "rec":
        rp = lp["rec"]
        gate = L.gelu(h @ rp["w_gate_in"].to(dt))
        main = h @ rp["w_main_in"].to(dt)
        main, conv_n = _causal_conv(main, rp["conv_w"], rp["conv_b"],
                                    cache["conv"])
        main, h_n = rglru_step(rp["lru"], main, cache["h"])
        t_out = (gate * main) @ rp["w_out"].to(dt)
        cache["conv"].copy_(conv_n)
        cache["h"].copy_(h_n)
    else:
        t_out, _ = L.decode_attention(lp["attn"], cfg.attn_cfg(), h, cache)
    x = x + t_out
    h = L.rmsnorm(lp["ln2"], x)
    return x + L.mlp(lp["mlp"], h, act="gelu")


def _conv_in_compute_dtype(caches: dict, dtype) -> None:
    """The reference's decode returns each recurrent layer's new conv tail
    in the compute dtype, so from the first step on its conv caches have
    that dtype: convert them once, then write in place."""
    for c in caches.values():
        if "conv" in c and c["conv"].dtype != dtype:
            c["conv"] = c["conv"].to(dtype)


def decode_step(params: dict, cfg: GriffinConfig, token: torch.Tensor,
                caches: dict):
    """One token; ``caches`` updated in place. Returns (logits (B, vocab)
    fp32, caches)."""
    x = _embed(params, cfg, token)
    _conv_in_compute_dtype({k: v for k, v in caches.items() if k != "tail"},
                           x.dtype)
    _conv_in_compute_dtype(caches["tail"], x.dtype)
    for b in optrace.trips("blocks", cfg.n_full_blocks):
        bp = L.block_view(params["blocks"], b)
        for i, kind in enumerate(cfg.pattern):
            x = _layer_decode(bp[f"l{i}"], cfg, kind, x,
                              L.block_view(caches[f"l{i}"], b))
    for i, kind in enumerate(cfg.tail):
        x = _layer_decode(params["tail"][f"l{i}"], cfg, kind, x,
                          caches["tail"][f"l{i}"])
    h = L.rmsnorm(params["final_norm"], x)
    return L.unembed(params["head"], h)[:, 0], caches


def prefill(params: dict, cfg: GriffinConfig, tokens: torch.Tensor):
    h = backbone(params, cfg, tokens)
    return L.unembed(params["head"], h[:, -1:])[:, 0], h
