"""Shared transformer building blocks (pure functions + dict params), the
port of ``repro.models.layers``.

Conventions, as in the reference:
  * params are nested dicts; leaf names and shapes are the reference's:
      embed (V, D) | wq/wk/wv (D, H*hd) | wo (H*hd, D)
      w_gate/w_up (D, F) | w_down (F, D) | unembed (D, V)
      scale (D,) norms | q_norm/k_norm (hd,)
  * weights are stored fp32; compute casts to ``dtype`` at each use (bf16
    on the card); norms, softmax and rope run in fp32.
  * attention supports GQA, causal & sliding-window masks, logit softcap,
    qk-norm, cross-attention, and single-token decode against a KV cache.

Every product is a torch matmul or einsum on the same operands and dtypes
as the reference's, so the port computes what it computes, op for op.

Training: ``remat`` is the port's ``jax.checkpoint`` (a non-reentrant
``torch.utils.checkpoint``; ``"dots"`` saves only the products), and
``chunked_xent`` the families' sequence-chunked cross-entropy. Both run
their functions plainly when autograd is off (serving).

KV caches are written IN PLACE: ``decode_attention`` (and ``attention``
with a cache) copies the new keys and values into the cache's tensors at
its device-side ``pos`` (``index_copy_``, no host sync), advances ``pos``
in place and returns the same dict. A model's stacked caches are updated
through per-block views, so a token never copies the cache. JAX clamps an
out-of-range start; ``index_copy_`` raises on one instead (a device-side
assert on the card), and generation never reaches one.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch.distributed import partitioned
from repro_torch.obs import optrace

NEG_INF = -2.3819763e38  # max bf16-representable negative; avoids inf-inf NaNs


# ---------------------------------------------------------------------------
# Initializers (the reference's ``repro.utils.dense_init`` / ``embed_init``)
# ---------------------------------------------------------------------------


def _normal(generator: torch.Generator, shape, std: float, device
            ) -> torch.Tensor:
    """N(0, std²) drawn leaf by leaf on the generator's device, then moved
    to ``device`` (no copy when they are the same). On the ``meta`` device
    nothing is drawn: the leaf has only its shape and dtype."""
    if torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=torch.float32, device="meta")
    out = torch.empty(tuple(shape), dtype=torch.float32,
                      device=generator.device)
    out.normal_(0.0, std, generator=generator)
    return out.to(device)


def dense_init(generator: torch.Generator, shape, device, *,
               scale: float | None = None, stack: tuple = ()
               ) -> torch.Tensor:
    """LeCun-normal dense kernel (fan_in, fan_out...): std 1/sqrt(fan_in).
    ``stack`` prepends the leading dims of stacked layers (the reference
    ``vmap``s the init, so fan_in is the unstacked shape's first dim)."""
    if scale is None:
        scale = 1.0 / math.sqrt(max(shape[0], 1))
    return _normal(generator, tuple(stack) + tuple(shape), scale, device)


def embed_init(generator: torch.Generator, shape, device, *,
               stack: tuple = ()) -> torch.Tensor:
    return _normal(generator, tuple(stack) + tuple(shape), 0.02, device)


def zeros(shape, device, stack: tuple = ()) -> torch.Tensor:
    return torch.zeros(tuple(stack) + tuple(shape), dtype=torch.float32,
                       device=device)


#: the products ``remat="dots"`` keeps for the backward (the reference's
#: ``dots_with_no_batch_dims_saveable``); everything else is recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn, mode: str = "nothing"):
    """``fn`` whose activations the backward recomputes, the port of
    ``jax.checkpoint``: ``"nothing"`` saves only its inputs, ``"dots"``
    also the outputs of its matrix products, ``"none"`` is ``fn`` itself.
    Without autograd (serving) ``fn`` runs as it is."""
    if mode == "none":
        return fn
    if mode not in ("nothing", "dots"):
        raise ValueError(f"unknown remat mode {mode!r}")

    def wrapped(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        if mode == "dots":
            kwargs["context_fn"] = functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots)
        return ckpt.checkpoint(optrace.pinned(fn), *args,
                               use_reentrant=False, **kwargs)

    return wrapped


def block_remat(fn, cfg):
    """``fn`` under ``remat``'s "nothing" (the reference's
    ``nothing_saveable``) unless ``cfg.remat`` is "none": the recurrent,
    encoder-decoder and vision families checkpoint their blocks so for any
    other setting."""
    return remat(fn, "none" if cfg.remat == "none" else "nothing")


def block_view(tree, b: int):
    """Block ``b`` of a stacked tree (leading dim = blocks): views, so an
    in-place write lands in the stacked tensor."""
    if isinstance(tree, dict):
        return {k: block_view(v, b) for k, v in tree.items()}
    return tree[b]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, device, stack: tuple = ()) -> dict:
    return {"scale": zeros((d,), device, stack)}  # gemma-style (1+scale)


def rmsnorm(p: dict, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + p["scale"])
    return y.to(x.dtype)


def init_layernorm(d: int, device, stack: tuple = ()) -> dict:
    return {"scale": torch.ones(tuple(stack) + (d,), dtype=torch.float32,
                                device=device),
            "bias": zeros((d,), device, stack)}


def layernorm(p: dict, x: torch.Tensor, *, eps: float = 1e-5
              ) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, *,
         theta: float = 10_000.0, scaling: float = 1.0) -> torch.Tensor:
    """x (..., S, H, hd); positions (..., S) int32. fp32 internally."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs / scaling   # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA / MQA / MHA, causal / sliding-window / cross, cached decode)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    rope_theta: float = 10_000.0
    rope_scaling: float = 1.0
    qk_norm: bool = False
    window: int | None = None        # sliding-window size (None = full)
    softcap: float | None = None     # attention-logit softcap
    use_rope: bool = True
    bias: bool = False               # projection biases (whisper)
    cache_upcast: bool = True        # decode: score on an fp32 cache copy
    # (baseline-faithful). False = §Perf O4: q and the attention weights
    # rounded to the cache dtype, products accumulated in fp32.


def init_attention(generator: torch.Generator, cfg: AttnCfg, device,
                   stack: tuple = ()) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {
        "wq": dense_init(generator, (d, h * hd), device, stack=stack),
        "wk": dense_init(generator, (d, kv * hd), device, stack=stack),
        "wv": dense_init(generator, (d, kv * hd), device, stack=stack),
        "wo": dense_init(generator, (h * hd, d), device, stack=stack),
    }
    if cfg.bias:
        p["bq"] = zeros((h * hd,), device, stack)
        p["bv"] = zeros((kv * hd,), device, stack)
        p["bo"] = zeros((d,), device, stack)
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, device, stack)
        p["k_norm"] = init_rmsnorm(hd, device, stack)
    return p


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor,
               window: int | None, causal: bool) -> torch.Tensor:
    """(..., S_q, S_k) additive fp32 mask from position vectors."""
    dq = q_pos[..., :, None]
    dk = k_pos[..., None, :]
    ok = torch.ones(torch.broadcast_shapes(dq.shape, dk.shape),
                    dtype=torch.bool, device=dq.device)
    if causal:
        ok = ok & (dk <= dq)
    if window is not None:
        ok = ok & (dk > dq - window)
    zero = torch.zeros((), dtype=torch.float32, device=dq.device)
    return torch.where(ok, zero, NEG_INF)


def _project_qkv(p: dict, cfg: AttnCfg, x: torch.Tensor,
                 src: torch.Tensor, biases: bool = True) -> tuple:
    """q (B, S, h, hd) from ``x``; k, v (B, Sk, kv, hd) from ``src``; with
    the biases (unless ``biases`` is False) and qk-norm (rope is the
    caller's)."""
    B, S, _ = x.shape
    Sk = src.shape[1]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, S, h, hd)
    if biases and "bq" in p:
        q = q + p["bq"].to(dt).reshape(h, hd)
    k = (src @ p["wk"].to(dt)).reshape(B, Sk, kv, hd)
    v = (src @ p["wv"].to(dt)).reshape(B, Sk, kv, hd)
    if biases and "bv" in p:
        v = v + p["bv"].to(dt).reshape(kv, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    return q, k, v


def _out_proj(p: dict, out: torch.Tensor, dt) -> torch.Tensor:
    y = out.to(dt) @ p["wo"].to(dt)
    if "bo" in p:
        y = y + p["bo"].to(dt)
    return y


def _softcap(s: torch.Tensor, cap: float | None) -> torch.Tensor:
    return s if cap is None else torch.tanh(s / cap) * cap


def attention(p: dict, cfg: AttnCfg, x: torch.Tensor,
              positions: torch.Tensor, *, kv_x: torch.Tensor | None = None,
              kv_positions: torch.Tensor | None = None,
              cache: dict | None = None, causal: bool = True) -> tuple:
    """General attention.

    x (B, S, D). Self-attention by default; pass ``kv_x`` for cross-attention
    (then causal/rope on kv side follow kv_positions and cache is ignored).
    With ``cache`` (dict k/v (B, S_max, kv, hd), pos 0-d int32): writes this
    call's kv at [pos, pos+S) in place, advances pos, and attends over the
    whole cache (decode / chunked prefill). Returns (out (B, S, D),
    cache|None).
    """
    B, S, D = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt = x.dtype
    q, k, v = _project_qkv(p, cfg, x, kv_x if kv_x is not None else x)

    k_pos = kv_positions if kv_positions is not None else positions
    if cfg.use_rope and kv_x is None:
        q = rope(q, positions, theta=cfg.rope_theta, scaling=cfg.rope_scaling)
        k = rope(k, k_pos, theta=cfg.rope_theta, scaling=cfg.rope_scaling)

    new_cache = None
    if cache is not None:
        # append at cache["pos"] (same for all rows: aligned serving batch)
        pos0 = cache["pos"]
        ck, cv = cache["k"], cache["v"]
        rows = pos0.long() + torch.arange(S, device=x.device)
        ck.index_copy_(1, rows, k.to(ck.dtype))
        cv.index_copy_(1, rows, v.to(cv.dtype))
        k, v = ck.to(dt), cv.to(dt)
        Sk = k.shape[1]
        k_pos = torch.arange(Sk, dtype=torch.int32, device=x.device)[None, :]
        # entries beyond pos0+S are invalid -> masked below via positions
        k_valid = k_pos < (pos0 + S)
        cache["pos"].add_(S)
        new_cache = cache
    else:
        k_valid = None
        if k_pos.ndim == 1:
            k_pos = k_pos[None, :]

    if positions.ndim == 1:
        positions = positions[None, :]

    # group query heads over kv heads: (B, S, kv, h/kv, hd)
    g = h // kv
    qg = q.reshape(B, S, kv, g, hd).float()
    scores = torch.einsum("bsngd,btnd->bnstg", qg, k.float()) / math.sqrt(hd)
    # scores: (B, kv, S_q, S_k=t, g) -> reorder to (B, kv, g, S_q, S_k)
    scores = torch.movedim(scores, -1, 2)
    scores = _softcap(scores, cfg.softcap)
    bias = _mask_bias(positions, k_pos, cfg.window,
                      causal and kv_x is None)           # (B, S_q, S_k)
    scores = scores + bias[:, None, None, :, :]
    if k_valid is not None:
        scores = torch.where(k_valid[:, None, None, None, :], scores,
                             NEG_INF)
    attn = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngst,btnd->bsngd", attn, v.float())
    return _out_proj(p, out.reshape(B, S, h * hd), dt), new_cache


def init_kv_cache(batch: int, max_len: int, cfg: AttnCfg,
                  dtype=torch.bfloat16, *, device, stack: tuple = ()
                  ) -> dict:
    shape = tuple(stack) + (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros(tuple(stack), dtype=torch.int32, device=device),
    }


def init_ring_cache(batch: int, window: int, cfg: AttnCfg,
                    dtype=torch.bfloat16, *, device, stack: tuple = ()
                    ) -> dict:
    """Rotating KV cache for sliding-window layers: O(window) memory
    regardless of sequence length (slot = absolute_position % window)."""
    shape = tuple(stack) + (batch, window, cfg.n_kv_heads, cfg.d_head)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "k_pos": torch.full(tuple(stack) + (window,), -1, dtype=torch.int32,
                            device=device),
        "pos": torch.zeros(tuple(stack), dtype=torch.int32, device=device),
    }


def decode_qkv(p: dict, cfg: AttnCfg, x: torch.Tensor, pos0, *,
               biases: bool = True) -> tuple:
    """One token's q (B, 1, h, hd), k, v (B, 1, kv, hd) at ``pos0``; the
    pruned decodes take no projection biases, as in the reference."""
    assert x.shape[1] == 1, "decode is single-token; use attention() else"
    q, k, v = _project_qkv(p, cfg, x, x, biases)
    if cfg.use_rope:
        positions = pos0[None, None]  # (1, 1)
        q = rope(q, positions, theta=cfg.rope_theta, scaling=cfg.rope_scaling)
        k = rope(k, positions, theta=cfg.rope_theta, scaling=cfg.rope_scaling)
    return q, k, v


def _index_write(c: torch.Tensor, dim: int, index: torch.Tensor,
                 new: torch.Tensor) -> None:
    """``c.index_copy_(dim, index, new)`` in place (``new`` cast to
    ``c``'s dtype); on a DTensor, each shard's local update, a cache split
    over its slots written by the shard that holds the slot
    (``partitioned.index_write``)."""
    if type(c) is not torch.Tensor:
        partitioned.index_write(c, dim, index, new)
    else:
        c.index_copy_(dim, index, new.to(c.dtype))


def decode_attention(p: dict, cfg: AttnCfg, x: torch.Tensor,
                     cache: dict) -> tuple:
    """Single-token decode (S=1) against a full or ring KV cache, written in
    place. Returns (out (B, 1, D), cache). Scores are (B, h, 1, S_cache) —
    linear in cache length, no chunking needed.
    """
    B = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt = x.dtype
    pos0 = cache["pos"]
    positions = pos0[None, None]  # (1, 1)
    q, k, v = decode_qkv(p, cfg, x, pos0)
    ck, cv = cache["k"], cache["v"]

    if "k_pos" in cache:  # ring cache
        W = ck.shape[1]
        slot = (pos0 % W).long().reshape(1)
        _index_write(ck, 1, slot, k)
        _index_write(cv, 1, slot, v)
        _index_write(cache["k_pos"], 0, slot, pos0.reshape(1))
        k_pos_b = cache["k_pos"][None, :]
        k_valid = cache["k_pos"] >= 0
    else:
        row = pos0.long().reshape(1)
        _index_write(ck, 1, row, k)
        _index_write(cv, 1, row, v)
        Sk = ck.shape[1]
        k_pos_b = torch.arange(Sk, dtype=torch.int32, device=x.device)[None]
        k_valid = k_pos_b[0] <= pos0

    g = h // kv
    qg = q.reshape(B, kv, g, hd)
    bias = _mask_bias(positions, k_pos_b, cfg.window, True)[:, 0]  # (1, S_k)
    if type(ck) is not torch.Tensor and partitioned.splits(ck, 1):
        # a cache split over its slots: the softmax by partials
        out = partitioned.decode_softmax(qg, ck, cv, bias, k_valid, cfg)
    else:
        if not cfg.cache_upcast:
            # q and the weights rounded to the cache dtype; their products
            # with the cache are exact in fp32 and accumulate there, as
            # the reference's preferred_element_type=float32 einsums do
            qg = qg.to(ck.dtype)
        scores = torch.einsum("bngd,btnd->bngt", qg.float(),
                              ck.float()) / math.sqrt(hd)
        scores = _softcap(scores, cfg.softcap)
        scores = scores + bias[:, None, None, :]
        scores = torch.where(k_valid[None, None, None, :], scores, NEG_INF)
        attn = torch.softmax(scores, dim=-1)
        if not cfg.cache_upcast:
            attn = attn.to(cv.dtype).float()
        out = torch.einsum("bngt,btnd->bngd", attn, cv.float())
    cache["pos"].add_(1)
    return _out_proj(p, out.reshape(B, 1, h * hd), dt), cache


def pruned_decode_attention(p: dict, cfg: AttnCfg, x: torch.Tensor,
                            cache: dict, keep: int,
                            prune_a: float = 0.0,
                            prune_w: float = -1.0) -> tuple:
    """Single-token decode with SAT-style positional KV pruning — the
    paper's prune-before-fetch at the KV cache: score every cache slot from
    POSITION metadata only (a + w*log1p(age)), keep the top-k, gather and
    attend over just those k rows. Scores depend only on positions, so the
    index set is shared across the batch and heads.

    Full (non-ring) caches only, written in place. Returns (out (B,1,D),
    cache).
    """
    B = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt = x.dtype
    pos0 = cache["pos"]
    ck, cv = cache["k"], cache["v"]
    Smax = ck.shape[1]
    q, knew, vnew = decode_qkv(p, cfg, x, pos0, biases=False)
    row = pos0.long().reshape(1)
    _index_write(ck, 1, row, knew)
    _index_write(cv, 1, row, vnew)

    # metadata-only scores -> top-k index set (shared across batch/heads)
    k_pos = torch.arange(Smax, dtype=torch.int32, device=x.device)
    age = torch.clamp(pos0 - k_pos, min=0).float()
    meta = prune_a + prune_w * torch.log1p(age)
    meta = torch.where(k_pos <= pos0, meta, -math.inf)
    # jax's top_k keeps the lower index among ties, torch.topk promises no
    # order. Valid slots have distinct ages, so only the -inf slots of
    # future positions can tie; they are masked to NEG_INF below and get
    # weight exactly 0, so which of them is taken cannot change the output.
    idx = torch.topk(meta, keep).indices

    g = h // kv
    if type(ck) is not torch.Tensor and partitioned.splits(ck, 1):
        # a cache split over its slots: each shard scores the kept slots
        # it holds, the softmax by partials
        valid = k_pos.index_select(0, idx) <= pos0
        out = partitioned.pruned_decode_softmax(
            q.reshape(B, kv, g, hd), ck, cv, idx, valid, cfg)
    else:
        k_sel = ck.index_select(1, idx)
        v_sel = cv.index_select(1, idx)
        pos_sel = k_pos.index_select(0, idx)
        qg = q.reshape(B, kv, g, hd).to(k_sel.dtype)
        s = torch.einsum("bngd,btnd->bngt", qg.float(),
                         k_sel.float()) / math.sqrt(hd)
        s = _softcap(s, cfg.softcap)
        valid = pos_sel <= pos0
        s = torch.where(valid[None, None, None, :], s, NEG_INF)
        attn = torch.softmax(s, dim=-1)
        out = torch.einsum("bngt,btnd->bngd", attn.to(v_sel.dtype).float(),
                           v_sel.float())
    cache["pos"].add_(1)
    y = out.reshape(B, 1, h * hd).to(dt) @ p["wo"].to(dt)
    if "bo" in p:
        y = y + p["bo"].to(dt)
    return y, cache


def _pad_rows(t: torch.Tensor, n: int, *, edge: bool = False
              ) -> torch.Tensor:
    """``t`` padded along dim 1 by ``n`` rows: zeros, or copies of its last
    row (``jnp.pad(mode="edge")``)."""
    if n == 0:
        return t
    if edge:
        tail = t[:, -1:].expand(t.shape[0], n, *t.shape[2:])
    else:
        tail = torch.zeros((t.shape[0], n, *t.shape[2:]), dtype=t.dtype,
                           device=t.device)
    return torch.cat([t, tail], dim=1)


def _online_softmax_step(m: torch.Tensor, l: torch.Tensor,
                         acc: torch.Tensor, s: torch.Tensor,
                         v: torch.Tensor) -> tuple:
    """One key block of the online softmax: the running max ``m``, sum
    ``l`` (B,kv,g,qb) and output ``acc`` (B,kv,g,qb,hd) rescaled to the
    new max, then the block's scores ``s`` (B,kv,g,qb,kb) and values ``v``
    (B,kb,kv,hd) added."""
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    alpha = torch.exp(m - m_new)
    ex = torch.exp(s - m_new[..., None])
    l = l * alpha + torch.sum(ex, dim=-1)
    acc = (acc * alpha[..., None]
           + torch.einsum("bngst,btnd->bngsd", ex, v.float()))
    return m_new, l, acc


def chunked_attention(p: dict, cfg: AttnCfg, x: torch.Tensor,
                      positions: torch.Tensor, *,
                      kv_x: torch.Tensor | None = None,
                      kv_positions: torch.Tensor | None = None,
                      causal: bool = True, q_block: int = 512,
                      k_block: int = 1024,
                      remat_qblocks: bool = False) -> torch.Tensor:
    """Flash-style attention: a loop over query blocks, an online softmax
    over key blocks. Peak live buffer is O(q_block * k_block) instead of
    O(S^2).

    ``remat_qblocks`` (the reference's §Perf H1): each query block's key
    loop runs under ``remat``, so the backward recomputes its scores
    instead of keeping every key step's fp32 scores; the values and
    gradients are the same.

    For sliding-window layers the key range per query block is exactly
    ``q_block + window`` wide, one slice — compute scales with the window,
    not the sequence.
    """
    B, S, D = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt = x.dtype
    g = h // kv
    dev = x.device

    q, k, v = _project_qkv(p, cfg, x, kv_x if kv_x is not None else x)
    Sk = k.shape[1]
    k_pos = kv_positions if kv_positions is not None else positions
    if k_pos.ndim == 1:
        k_pos = k_pos[None, :].expand(B, Sk)
    if positions.ndim == 1:
        positions = positions[None, :].expand(B, S)
    if cfg.use_rope and kv_x is None:
        q = rope(q, positions, theta=cfg.rope_theta, scaling=cfg.rope_scaling)
        k = rope(k, k_pos, theta=cfg.rope_theta, scaling=cfg.rope_scaling)

    is_causal = causal and kv_x is None

    # pad S to a q_block multiple and Sk to a k_block multiple; padded key
    # slots carry kv_ok=False and are masked to NEG_INF, padded query rows
    # are sliced off at the end.
    qb = min(q_block, S)
    S_p = -(-S // qb) * qb
    kb = min(k_block, Sk)
    Sk_p = -(-Sk // kb) * kb
    q = _pad_rows(q, S_p - S)
    positions = _pad_rows(positions, S_p - S, edge=True)
    kv_ok = torch.arange(Sk_p, device=dev) < Sk
    k = _pad_rows(k, Sk_p - Sk)
    v = _pad_rows(v, Sk_p - Sk)
    k_pos = _pad_rows(k_pos, Sk_p - Sk, edge=True)
    S_orig, S, Sk = S, S_p, Sk_p
    n_q = S // qb
    scale = math.sqrt(hd)

    def score_block(qi, ki, qpos_i, kpos_i, ok_i):
        """(B,qb,kv,g,hd),(B,kb,kv,hd) -> (B,kv,g,qb,kb) fp32 masked scores."""
        s = torch.einsum("bsngd,btnd->bngst", qi.float(), ki.float()) / scale
        s = _softcap(s, cfg.softcap)
        bias = _mask_bias(qpos_i, kpos_i, cfg.window, is_causal)
        bias = torch.where(ok_i[None, None, :], bias, NEG_INF)
        return s + bias[:, None, None, :, :]

    blocks = []
    if cfg.window is not None and kv_x is None:
        # windowed path: one K slice of width qb + window per query block
        Wk = min(cfg.window + qb, Sk)
        for i in optrace.trips("attn_q", n_q):
            qi = q[:, i * qb:(i + 1) * qb].reshape(B, qb, kv, g, hd)
            qpos_i = positions[:, i * qb:(i + 1) * qb]
            start = min(max(i * qb + qb - Wk, 0), Sk - Wk)
            sl = slice(start, start + Wk)
            s = score_block(qi, k[:, sl], qpos_i, k_pos[:, sl], kv_ok[sl])
            a = torch.softmax(s, dim=-1)
            o = torch.einsum("bngst,btnd->bsngd", a, v[:, sl].float())
            blocks.append(o.reshape(B, qb, h, hd))
    else:
        n_k = Sk // kb

        def q_inner(qi, qpos_i, k_, v_, kpos_, ok_):
            m = torch.full((B, kv, g, qb), -math.inf, dtype=torch.float32,
                           device=dev)
            l = torch.zeros((B, kv, g, qb), dtype=torch.float32, device=dev)
            acc = torch.zeros((B, kv, g, qb, hd), dtype=torch.float32,
                              device=dev)
            for j in optrace.trips("attn_k", n_k):
                sl = slice(j * kb, (j + 1) * kb)
                s = score_block(qi, k_[:, sl], qpos_i, kpos_[:, sl],
                                ok_[sl])                   # (B,kv,g,qb,kb)
                m, l, acc = _online_softmax_step(m, l, acc, s, v_[:, sl])
            o = acc / torch.clamp(l, min=1e-30)[..., None]  # (B,kv,g,qb,hd)
            return torch.movedim(o, 3, 1).reshape(B, qb, h, hd)

        if remat_qblocks:
            q_inner = remat(q_inner)
        for i in optrace.trips("attn_q", n_q):
            qi = q[:, i * qb:(i + 1) * qb].reshape(B, qb, kv, g, hd)
            qpos_i = positions[:, i * qb:(i + 1) * qb]
            blocks.append(q_inner(qi, qpos_i, k, v, k_pos, kv_ok))

    blocks = optrace.fill(blocks, n_q)
    out = torch.cat(blocks, dim=1).reshape(B, S, h * hd)
    return _out_proj(p, out[:, :S_orig], dt)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(generator: torch.Generator, d: int, f: int, device, *,
             gated: bool = True, stack: tuple = ()) -> dict:
    p = {"w_up": dense_init(generator, (d, f), device, stack=stack),
         "w_down": dense_init(generator, (f, d), device, stack=stack)}
    if gated:
        p["w_gate"] = dense_init(generator, (d, f), device, stack=stack)
    return p


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)``: the tanh form (torch's default is
    the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def mlp(p: dict, x: torch.Tensor, *, act: str = "silu") -> torch.Tensor:
    dt = x.dtype
    up = x @ p["w_up"].to(dt)
    if "w_gate" in p:
        gate = x @ p["w_gate"].to(dt)
        hidden = (F.silu(gate) if act == "silu" else gelu(gate)) * up
    else:
        hidden = gelu(up)
    return hidden @ p["w_down"].to(dt)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def init_embed(generator: torch.Generator, vocab: int, d: int, device
               ) -> dict:
    return {"embed": embed_init(generator, (vocab, d), device)}


def embed(p: dict, tokens: torch.Tensor, dtype=torch.bfloat16
          ) -> torch.Tensor:
    # gather, then cast: the same bits as the reference's cast-then-gather,
    # without casting the whole table every token. In bf16 the backward
    # sums a token's repeated rows in fp32, where the reference sums them
    # in bf16 (tests/test_torch_lm_train_io.py holds it to a bf16 limit).
    # A table split over the vocab on ``model`` (a DTensor) is looked up
    # without gathering it (``partitioned.embed``).
    table = p["embed"]
    if type(table) is not torch.Tensor and partitioned.embed_splits(table):
        return partitioned.embed(table, tokens).to(dtype)
    return table[tokens.long()].to(dtype)


def init_unembed(generator: torch.Generator, d: int, vocab: int, device
                 ) -> dict:
    return {"unembed": dense_init(generator, (d, vocab), device)}


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    # logits in fp32 for a numerically-stable softmax/cross-entropy
    return (x @ p["unembed"].to(x.dtype)).float()


# ---------------------------------------------------------------------------
# Training loss
# ---------------------------------------------------------------------------


def _xent_sum(hi: torch.Tensor, ti: torch.Tensor, w: torch.Tensor
              ) -> torch.Tensor:
    """Summed next-token cross-entropy of one sequence chunk, fp32. Logits
    split over the vocab on ``model`` (a DTensor) take the vocab-parallel
    form (``distributed/partitioned.xent_sum``)."""
    logits = (hi @ w.to(hi.dtype)).float()
    if type(logits) is not torch.Tensor and partitioned.splits(logits, -1):
        return partitioned.xent_sum(logits, ti)
    lse = torch.logsumexp(logits, dim=-1)
    # (B, c, 1) until the sum: over a vocab-sharded DTensor (the dry run)
    # the gathered column is a masked partial, reducible at its own shape
    gold = torch.gather(logits, -1, ti[..., None].long())
    return torch.sum(lse[..., None] - gold)


def chunked_xent(h: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                 loss_chunk: int) -> torch.Tensor:
    """Mean next-token cross-entropy of hidden states ``h`` (B, S, D)
    through the unembedding ``w`` (D, V), the families' ``loss_fn`` tail:
    the sequence in chunks of ``loss_chunk``, each chunk's fp32 logits
    recomputed in the backward (the reference's ``jax.checkpoint(step)``),
    so no (B, S, V) tensor is ever kept. The chunk sums are added in order
    from zero; as in the reference, a remainder of S past the last whole
    chunk is left out of the sum but not of the mean's count."""
    B, S, _ = h.shape
    chunk = min(loss_chunk, S)
    step = remat(_xent_sum)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(S // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + step(h[:, sl], targets[:, sl], w)
    return total / (B * S)
