"""Whisper-style encoder-decoder backbone (audio frontend stubbed), the port
of ``repro.models.whisper``.

The conv frontend is a STUB: the encoder consumes precomputed mel-frame
embeddings (B, n_frames, D) directly (adding sinusoidal positions).
Pre-LayerNorm blocks with biased projections and plain-GELU MLPs; decoder
layers add cross-attention to the encoder output.

Decode runs the DECODER: a single-token step against a self-KV cache plus
fixed cross K/V computed once from the encoder output.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.models import layers as L
from repro_torch.models.layers import embed_init
from repro_torch.obs import optrace
from repro_torch.utils import FrozenConfig


@dataclasses.dataclass(frozen=True)
class WhisperConfig(FrozenConfig):
    arch: str = "whisper"
    n_layers: int = 4           # encoder AND decoder layer count
    d_model: int = 384
    n_heads: int = 6
    n_kv_heads: int = 6
    d_head: int = 64
    d_ff: int = 1536
    vocab: int = 51_865
    n_frames: int = 1500        # encoder positions (30s of audio)
    max_target: int = 448       # decoder learned-position table size (tiled
                                # when serving beyond it)
    dtype: str = "bfloat16"
    remat: str = "nothing"
    q_block: int = 512
    k_block: int = 512
    loss_chunk: int = 512

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def attn_cfg(self) -> L.AttnCfg:
        return L.AttnCfg(d_model=self.d_model, n_heads=self.n_heads,
                         n_kv_heads=self.n_kv_heads, d_head=self.d_head,
                         use_rope=False, bias=True)

    @property
    def n_params(self) -> int:
        d, f = self.d_model, self.d_ff
        attn = 4 * d * self.n_heads * self.d_head
        mlp = 2 * d * f
        enc = self.n_layers * (attn + mlp + 4 * d)
        dec = self.n_layers * (2 * attn + mlp + 6 * d)
        return self.vocab * d + self.max_target * d + enc + dec + 4 * d

    n_active_params = n_params


def _sinusoid(n: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10_000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _init_enc_layer(generator, cfg, device, st):
    return {"ln1": L.init_layernorm(cfg.d_model, device, st),
            "attn": L.init_attention(generator, cfg.attn_cfg(), device, st),
            "ln2": L.init_layernorm(cfg.d_model, device, st),
            "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, device,
                              gated=False, stack=st)}


def _init_dec_layer(generator, cfg, device, st):
    return {"ln1": L.init_layernorm(cfg.d_model, device, st),
            "attn": L.init_attention(generator, cfg.attn_cfg(), device, st),
            "ln_x": L.init_layernorm(cfg.d_model, device, st),
            "xattn": L.init_attention(generator, cfg.attn_cfg(), device, st),
            "ln2": L.init_layernorm(cfg.d_model, device, st),
            "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, device,
                              gated=False, stack=st)}


def init(generator: torch.Generator, cfg: WhisperConfig, device) -> dict:
    """Stacked params: enc.* and dec.* leaves have leading dim n_layers."""
    st = (cfg.n_layers,)
    return {
        "embed": L.init_embed(generator, cfg.vocab, cfg.d_model, device),
        "pos_dec": embed_init(generator, (cfg.max_target, cfg.d_model),
                              device),
        "enc": _init_enc_layer(generator, cfg, device, st),
        "dec": _init_dec_layer(generator, cfg, device, st),
        "enc_norm": L.init_layernorm(cfg.d_model, device),
        "dec_norm": L.init_layernorm(cfg.d_model, device),
    }


def encode(params: dict, cfg: WhisperConfig, frames: torch.Tensor
           ) -> torch.Tensor:
    """frames (B, n_frames, D) — precomputed frontend embeddings (stub)."""
    B, S, D = frames.shape
    dt = cfg.compute_dtype
    x = frames.to(dt) + _sinusoid(S, D, frames.device).to(dt)
    positions = torch.arange(S, dtype=torch.int32, device=frames.device)

    def body(lp, x):
        h = L.layernorm(lp["ln1"], x)
        a, _ = L.attention(lp["attn"], cfg.attn_cfg(), h, positions,
                           causal=False)
        x = x + a
        h = L.layernorm(lp["ln2"], x)
        return x + L.mlp(lp["mlp"], h)

    body = L.block_remat(body, cfg)
    x = shd.constrain(x, "carry")
    for i in optrace.trips("enc_layers", cfg.n_layers):
        x = shd.constrain(body(L.block_view(params["enc"], i), x), "carry")
    return L.layernorm(params["enc_norm"], x)


def _dec_layer(lp, cfg, x, positions, enc_out, enc_pos):
    h = L.layernorm(lp["ln1"], x)
    a = L.chunked_attention(lp["attn"], cfg.attn_cfg(), h, positions,
                            q_block=cfg.q_block, k_block=cfg.k_block)
    x = x + a
    h = L.layernorm(lp["ln_x"], x)
    a = L.chunked_attention(lp["xattn"], cfg.attn_cfg(), h, positions,
                            kv_x=enc_out, kv_positions=enc_pos, causal=False,
                            q_block=cfg.q_block, k_block=cfg.k_block)
    x = x + a
    h = L.layernorm(lp["ln2"], x)
    return x + L.mlp(lp["mlp"], h)


def _dec_positions(params, cfg, positions):
    """Learned decoder positions, tiled when serving beyond max_target."""
    return params["pos_dec"][(positions % cfg.max_target).long()]


def decode_train(params: dict, cfg: WhisperConfig, tokens: torch.Tensor,
                 enc_out: torch.Tensor) -> torch.Tensor:
    """The decoder over a whole token sequence (teacher-forced forward)."""
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = L.embed(params["embed"], tokens, cfg.compute_dtype)
    x = x + _dec_positions(params, cfg, positions).to(x.dtype)
    enc_pos = torch.arange(enc_out.shape[1], dtype=torch.int32,
                           device=tokens.device)
    body = L.block_remat(_dec_layer, cfg)
    x = shd.constrain(x, "carry")
    for i in optrace.trips("dec_layers", cfg.n_layers):
        x = shd.constrain(body(L.block_view(params["dec"], i), cfg, x,
                               positions, enc_out, enc_pos), "carry")
    return L.layernorm(params["dec_norm"], x)


def loss_fn(params: dict, cfg: WhisperConfig, frames: torch.Tensor,
            tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The decoder's mean next-token cross-entropy given the encoder's
    frames. The unembedding is the embedding table, transposed (tied, as
    in Whisper), so its gradient sums both uses."""
    enc_out = encode(params, cfg, frames)
    h = decode_train(params, cfg, tokens, enc_out)
    return L.chunked_xent(h, params["embed"]["embed"].T, targets,
                          cfg.loss_chunk)


def _logits(params: dict, h: torch.Tensor) -> torch.Tensor:
    # tied unembedding, as in Whisper
    return (h @ params["embed"]["embed"].T.to(h.dtype)).float()


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def init_caches(cfg: WhisperConfig, batch: int, max_len: int,
                params: dict | None = None,
                enc_out: torch.Tensor | None = None,
                dtype=torch.bfloat16, *, device=None) -> dict:
    """Self caches for every decoder layer + cross K/V (computed once from
    the encoder output when ``params`` + ``enc_out`` are given, else zeros).
    ``device`` defaults to ``enc_out``'s."""
    if device is None:
        device = enc_out.device
    nl = cfg.n_layers
    self_c = L.init_kv_cache(batch, max_len, cfg.attn_cfg(), dtype,
                             device=device, stack=(nl,))
    kv, hd = cfg.n_kv_heads, cfg.d_head
    if params is not None and enc_out is not None:
        S = enc_out.shape[1]
        dt = enc_out.dtype
        ks, vs = [], []
        for i in range(nl):  # one decoder layer's cross K/V at a time
            xp = L.block_view(params["dec"], i)["xattn"]
            k = enc_out @ xp["wk"].to(dt)
            v = enc_out @ xp["wv"].to(dt) + xp["bv"].to(dt)
            ks.append(k.reshape(batch, S, kv, hd).to(dtype))
            vs.append(v.reshape(batch, S, kv, hd).to(dtype))
        ck, cv = torch.stack(ks), torch.stack(vs)
    else:
        ck = torch.zeros((nl, batch, cfg.n_frames, kv, hd), dtype=dtype,
                         device=device)
        cv = torch.zeros_like(ck)
    return {"self": self_c, "cross_k": ck, "cross_v": cv}


def decode_step(params: dict, cfg: WhisperConfig, token: torch.Tensor,
                caches: dict):
    """One token; the self caches are updated in place. Returns (logits
    (B, vocab) fp32, caches)."""
    B = token.shape[0]
    x = L.embed(params["embed"], token, cfg.compute_dtype)
    pos0 = caches["self"]["pos"][0]
    x = x + _dec_positions(params, cfg, pos0[None]).to(x.dtype)[None]
    hd_, kvh = cfg.d_head, cfg.n_kv_heads
    for i in optrace.trips("dec_layers", cfg.n_layers):
        lp = L.block_view(params["dec"], i)
        h = L.layernorm(lp["ln1"], x)
        a, _ = L.decode_attention(lp["attn"], cfg.attn_cfg(), h,
                                  L.block_view(caches["self"], i))
        x = x + a
        # cross-attention: q for 1 token over fixed enc K/V
        h = L.layernorm(lp["ln_x"], x)
        dt = h.dtype
        xp = lp["xattn"]
        q = (h @ xp["wq"].to(dt) + xp["bq"].to(dt)).reshape(
            B, kvh, cfg.n_heads // kvh, hd_)
        s = torch.einsum("bngd,btnd->bngt", q.float(),
                         caches["cross_k"][i].float()) / math.sqrt(hd_)
        attn = torch.softmax(s, dim=-1)
        o = torch.einsum("bngt,btnd->bngd", attn,
                         caches["cross_v"][i].float())
        o = o.reshape(B, 1, cfg.n_heads * hd_).to(dt)
        x = x + (o @ xp["wo"].to(dt) + xp["bo"].to(dt))
        h = L.layernorm(lp["ln2"], x)
        x = x + L.mlp(lp["mlp"], h)
    h = L.layernorm(params["dec_norm"], x)
    return _logits(params, h)[:, 0], caches


def prefill(params: dict, cfg: WhisperConfig, frames: torch.Tensor,
            tokens: torch.Tensor):
    enc_out = encode(params, cfg, frames)
    h = decode_train(params, cfg, tokens, enc_out)
    return _logits(params, h[:, -1:])[:, 0], enc_out
