"""LM serving: the batched prefill + decode generation loop, and the
beyond-paper positional KV pruning; the port of ``repro.serving.lm_serve``.

``pruned_decode_attention`` is the decode-time analogue of the paper's SAT
neighbor pruning: score every KV-cache entry from POSITION METADATA ONLY
(a + w * log1p(t_now - t_kv), per kv head), select top-k, and attend over
just those k entries — the cache gather shrinks from S to k rows exactly as
the paper's neighbor fetch shrinks from m_r to k. Off by default.

``generate`` runs on the device of its prompts. On the card it
synchronizes once before each clock read (a phase's start and end, never
per token), so ``prefill_s`` and ``decode_s_per_tok`` are the card's
times, not the host's time to queue the work. Sampling draws Gumbel noise
from a ``torch.Generator`` on that device seeded with ``ServeConfig.seed``:
reproducible by seed, but not the reference's ``jax.random`` draws; greedy
decoding (temperature 0) takes the same tokens as the reference.
"""
from __future__ import annotations

import dataclasses
import math
import time

import torch

from repro_torch.models import layers as L
from repro_torch.models import lm_common
from repro_torch.utils import FrozenConfig


# ---------------------------------------------------------------------------
# beyond-paper: SAT-style positional KV pruning
# ---------------------------------------------------------------------------


def init_kv_prune(n_kv_heads: int, device) -> dict:
    """Learnable recency scoring per kv head: score = a + w * log1p(age)."""
    return {"a": torch.zeros((n_kv_heads,), dtype=torch.float32,
                             device=device),
            "w": torch.full((n_kv_heads,), -1.0, dtype=torch.float32,
                            device=device)}


def kv_prune_scores(prune_p: dict, k_pos: torch.Tensor, now: torch.Tensor,
                    n_kv_heads: int) -> torch.Tensor:
    """k_pos (S,) absolute positions (-1 invalid) -> scores (kv, S)."""
    age = torch.clamp(now - k_pos, min=0).float()
    base = prune_p["a"][:, None] + prune_p["w"][:, None] * torch.log1p(age)
    return torch.where(k_pos[None, :] >= 0, base, -math.inf)


def pruned_decode_attention(p: dict, cfg: L.AttnCfg, x: torch.Tensor,
                            cache: dict, prune_p: dict, keep: int):
    """decode_attention with SAT-style positional top-k cache pruning.

    The interface of layers.decode_attention (full cache only, written in
    place). Scores depend only on positions -> the top-k index set is
    shared across the batch, so the gather is a (k,)-indexed slice of the
    cache.
    """
    B = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt = x.dtype
    pos0 = cache["pos"]
    ck, cv = cache["k"], cache["v"]
    Smax = ck.shape[1]
    k_pos = torch.arange(Smax, dtype=torch.int32, device=x.device)
    k_pos = torch.where(k_pos <= pos0, k_pos, -1)

    # write this token's kv first (it must be retrievable later)
    q, knew, vnew = L.decode_qkv(p, cfg, x, pos0, biases=False)
    row = pos0.long().reshape(1)
    ck.index_copy_(1, row, knew.to(ck.dtype))
    cv.index_copy_(1, row, vnew.to(cv.dtype))

    # SAT-style: score from positions ONLY, then fetch only the winners.
    # (head-0 scores pick the shared index set.) jax's top_k keeps the
    # lower index among ties, torch.topk promises no order: only the -inf
    # slots of future positions can tie, and they are masked below to
    # weight exactly 0, so which of them is taken cannot change the output.
    scores_meta = kv_prune_scores(prune_p, k_pos, pos0, kv)      # (kv, Smax)
    idx = torch.topk(scores_meta[0], keep).indices               # (keep,)
    k_sel = ck.index_select(1, idx).float()                      # (B,keep,kv,hd)
    v_sel = cv.index_select(1, idx).float()
    pos_sel = k_pos.index_select(0, idx)

    g = h // kv
    qg = q.reshape(B, kv, g, hd).float()
    s = torch.einsum("bngd,btnd->bngt", qg, k_sel) / math.sqrt(hd)
    if cfg.softcap is not None:
        s = torch.tanh(s / cfg.softcap) * cfg.softcap
    valid = (pos_sel >= 0) & (pos_sel <= pos0)
    s = torch.where(valid[None, None, None, :], s, L.NEG_INF)
    attn = torch.softmax(s, dim=-1)
    out = torch.einsum("bngt,btnd->bngd", attn, v_sel).reshape(B, 1, h * hd)
    cache["pos"].add_(1)
    return out.to(dt) @ p["wo"].to(dt), cache


# ---------------------------------------------------------------------------
# generation loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServeConfig(FrozenConfig):
    max_new_tokens: int = 32
    temperature: float = 0.0       # 0 = greedy
    seed: int = 0


def _clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def generate(params, cfg, prompts: torch.Tensor, scfg: ServeConfig,
             max_len: int | None = None) -> dict:
    """Batched generation for any registered family, on ``prompts``'
    device.

    prompts (B, S_prompt) int32. Returns {"tokens": (B, S_prompt+new) int32,
    "prefill_s": ..., "decode_s_per_tok": ...}.
    """
    fam = lm_common.family_of(cfg)
    mod = lm_common.FAMILIES[fam]
    B, Sp = prompts.shape
    dev = prompts.device
    total = Sp + scfg.max_new_tokens if max_len is None else max_len

    # the transformer family decodes against fp32 caches, the others
    # against their default (bf16) ones, as in the reference
    caches = (mod.init_caches(cfg, B, total, dtype=torch.float32, device=dev)
              if fam == "transformer" else
              mod.init_caches(cfg, B, total, device=dev))

    t0 = _clock(dev)
    logits = None
    for t in range(Sp):  # teacher-forced prompt consumption via decode path
        logits, caches = mod.decode_step(params, cfg, prompts[:, t:t + 1],
                                         caches)
    prefill_s = _clock(dev) - t0

    gen = torch.Generator(device=dev).manual_seed(scfg.seed)
    out = [prompts.to(torch.int32)]
    t0 = _clock(dev)
    for _ in range(scfg.max_new_tokens):
        if scfg.temperature > 0:
            # Gumbel-max: argmax(logits / T + G) samples softmax(logits / T)
            u = torch.rand(logits.shape, generator=gen, device=dev)
            tok = torch.argmax(logits / scfg.temperature
                               - torch.log(-torch.log(u)), dim=-1)
        else:
            tok = torch.argmax(logits, dim=-1)
        tok = tok.to(torch.int32)[:, None]
        out.append(tok)
        logits, caches = mod.decode_step(params, cfg, tok, caches)
    decode_s = (_clock(dev) - t0) / max(scfg.max_new_tokens, 1)

    return {"tokens": torch.cat(out, dim=1), "prefill_s": prefill_s,
            "decode_s_per_tok": decode_s}
