"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060) language model, the
port of ``repro.models.mamba2``.

The SSD layer computes, per head h with scalar decay A_h < 0:

    state_t = exp(dt_t A) state_{t-1} + dt_t B_t x_t^T        (P x N outer)
    y_t     = C_t . state_t + D x_t

Training and prefill use the chunked block-decomposition (the "duality"):
sequences are split into chunks of Q tokens; within a chunk the quadratic
form (C_t.B_s) exp(l_t - l_s) dt_s runs like attention, across chunks a
loop carries the (B, H, P, N) state. Because A < 0 and dt > 0 every
exponent that is kept is <= 0 — all decays live in (0, 1]. The pairs
above the diagonal (s > t) are masked, and their exponents are positive
sums of up to Q - 1 terms; the reference takes their ``exp`` and masks
the result, which overflows to inf at Q = 256 and turns the backward's
zero cotangent times inf into NaN. The port masks the exponent first
(``_intra_decay``): the same values, finite gradients.

Decode is the O(1) recurrence.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import partitioned
from repro_torch.distributed import sharding as shd
from repro_torch.models import layers as L
from repro_torch.models.layers import dense_init
from repro_torch.obs import optrace
from repro_torch.utils import FrozenConfig


@dataclasses.dataclass(frozen=True)
class MambaConfig(FrozenConfig):
    arch: str = "mamba2"
    n_layers: int = 24
    d_model: int = 768
    expand: int = 2
    d_head: int = 64            # SSD head dim P
    d_state: int = 128          # N
    n_groups: int = 1           # B/C groups G
    conv_width: int = 4
    vocab: int = 50_280
    chunk: int = 128            # SSD chunk length Q
    dtype: str = "bfloat16"
    remat: str = "nothing"
    loss_chunk: int = 512

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.d_head

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def n_params(self) -> int:
        d, di = self.d_model, self.d_inner
        proj_in = d * (2 * di + 2 * self.n_groups * self.d_state
                       + self.n_heads)
        conv = self.conv_dim * self.conv_width
        per_layer = (proj_in + conv + 3 * self.n_heads + di * d + d + di)
        return self.vocab * d * 2 + self.n_layers * per_layer + d

    n_active_params = n_params


def init(generator: torch.Generator, cfg: MambaConfig, device) -> dict:
    """Stacked params: layers.* leaves have leading dim n_layers."""
    st = (cfg.n_layers,)
    H = cfg.n_heads

    def per_layer(v: torch.Tensor) -> torch.Tensor:
        return v.to(device).expand(*st, *v.shape).contiguous()

    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32))
    dt_bias = torch.log(torch.expm1(
        torch.logspace(-3, -1, H, dtype=torch.float32)))  # softplus^-1
    layers = {
        "norm": L.init_rmsnorm(cfg.d_model, device, st),
        "in_proj": dense_init(generator, (cfg.d_model,
                                          2 * cfg.d_inner
                                          + 2 * cfg.n_groups * cfg.d_state
                                          + H), device, stack=st),
        "conv_w": dense_init(generator, (cfg.conv_width, cfg.conv_dim),
                             device, scale=0.5, stack=st),
        "conv_b": L.zeros((cfg.conv_dim,), device, st),
        "a_log": per_layer(a_log),
        "d_skip": per_layer(torch.ones(H)),
        "dt_bias": per_layer(dt_bias),
        "gate_norm": L.init_rmsnorm(cfg.d_inner, device, st),
        "out_proj": dense_init(generator, (cfg.d_inner, cfg.d_model), device,
                               stack=st),
    }
    return {
        "embed": L.init_embed(generator, cfg.vocab, cfg.d_model, device),
        "layers": layers,
        "final_norm": L.init_rmsnorm(cfg.d_model, device),
        "head": L.init_unembed(generator, cfg.d_model, cfg.vocab, device),
    }


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def _split_proj(cfg: MambaConfig, zxbcdt: torch.Tensor):
    di, g, n = cfg.d_inner, cfg.n_groups, cfg.d_state
    z = zxbcdt[..., :di]
    x = zxbcdt[..., di:2 * di]
    b = zxbcdt[..., 2 * di:2 * di + g * n]
    c = zxbcdt[..., 2 * di + g * n:2 * di + 2 * g * n]
    dt = zxbcdt[..., 2 * di + 2 * g * n:]
    return z, x, b, c, dt


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv. x (B, L, C), w (K, C). With ``state``
    (B, K-1, C) — streaming mode: prepend and return the new tail."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    n = x.shape[1]
    out = 0
    for i in range(K):        # Python's sum: 0 + term_0 + term_1 + ...
        out = out + xp[:, i:i + n] * w[i].to(x.dtype)
    out = F.silu(out + b.to(x.dtype))
    new_state = xp[:, -(K - 1):] if K > 1 else pad
    return out, new_state


def _intra_decay(lt: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
    """exp(l_t - l_s) for t >= s and 0 above the diagonal, from the chunk's
    cumulative log-decays ``lt`` (B,H,Q): (B,H,Q,Q). The exponent is masked
    before the ``exp`` (bitwise the reference's masked ``exp`` where that
    is finite), so no pair overflows and the backward stays finite."""
    diff = lt[:, :, :, None] - lt[:, :, None, :]
    return torch.exp(torch.where(causal, diff, -math.inf))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int,
                h0: torch.Tensor | None = None):
    """SSD scan. x (B,L,H,P) fp32; dt (B,L,H) >0; a (H,) <0;
    b,c (B,L,G,N). Returns (y (B,L,H,P), h_final (B,H,P,N)). DTensors
    split over the sequence on ``model`` run the scan on a shard's heads
    (``distributed/partitioned.ssd_chunked``)."""
    if type(x) is not torch.Tensor and partitioned.ssd_splits(x, dt, b, c):
        return partitioned.ssd_chunked(_ssd_scan, x, dt, a, b, c, chunk, h0)
    return _ssd_scan(x, dt, a, b, c, chunk, h0)


def _ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor, chunk: int,
              h0: torch.Tensor | None = None):
    """``ssd_chunked`` on one device: the loop over chunks."""
    B, Lx, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    Q = min(chunk, Lx)
    assert Lx % Q == 0, (Lx, Q)
    rep = H // G
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    qi = torch.arange(Q, device=x.device)
    causal = qi[:, None] >= qi[None, :]

    ys = []
    for ci in optrace.trips("ssd_chunk", Lx // Q):
        sl = slice(ci * Q, (ci + 1) * Q)
        x_c, dt_c, b_c, c_c = x[:, sl], dt[:, sl], b[:, sl], c[:, sl]
        la = dt_c * a                                # (B,Q,H) log-decays <0
        l = torch.cumsum(la, dim=1)                  # inclusive
        l_last = l[:, -1]                            # (B,H)
        bh = torch.repeat_interleave(b_c, rep, dim=2)  # (B,Q,H,N)
        ch = torch.repeat_interleave(c_c, rep, dim=2)

        # inter-chunk: y_t += exp(l_t) C_t . h_in
        y_inter = torch.exp(l)[..., None] * torch.einsum(
            "bqhn,bhpn->bqhp", ch, h)

        # intra-chunk quadratic form
        scores = torch.einsum("bqhn,bshn->bhqs", ch, bh)
        lt = l.permute(0, 2, 1)                      # (B,H,Q)
        decay = _intra_decay(lt, causal)
        dt_s = dt_c.permute(0, 2, 1)[:, :, None, :]  # (B,H,1,Q) dt at s
        w = scores * decay * dt_s                    # (B,H,Q,Q)
        y_intra = torch.einsum("bhqs,bshp->bqhp", w, x_c)

        # state carry
        carry_dec = torch.exp(l_last)                # (B,H)
        w_state = dt_c * torch.exp(l_last[:, None] - l)  # (B,Q,H)
        h = h * carry_dec[..., None, None] + torch.einsum(
            "bqhn,bqhp,bqh->bhpn", bh, x_c, w_state)
        ys.append(y_inter + y_intra)
    return torch.cat(optrace.fill(ys, Lx // Q), dim=1), h


def ssd_ref(x, dt, a, b, c):
    """Naive per-step recurrence oracle (tests)."""
    B, Lx, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    bh = torch.repeat_interleave(b, rep, dim=2)
    ch = torch.repeat_interleave(c, rep, dim=2)
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(Lx):
        xt, dtt, bt, ct = x[:, t], dt[:, t], bh[:, t], ch[:, t]
        dec = torch.exp(dtt * a)                     # (B,H)
        h = h * dec[..., None, None] + torch.einsum(
            "bhn,bhp,bh->bhpn", bt, xt, dtt)
        ys.append(torch.einsum("bhn,bhpn->bhp", ct, h))
    return torch.stack(ys, dim=1)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def _layer_fwd(lp: dict, cfg: MambaConfig, x: torch.Tensor,
               conv_state=None, ssm_state=None, streaming: bool = False):
    dt_c = x.dtype
    B, Lx, D = x.shape
    h = L.rmsnorm(lp["norm"], x)
    zxbcdt = h @ lp["in_proj"].to(dt_c)
    z, xs, b, c, dt = _split_proj(cfg, zxbcdt)

    conv_in = torch.cat([xs, b, c], dim=-1)
    conv_out, new_conv = _causal_conv(conv_in, lp["conv_w"], lp["conv_b"],
                                      conv_state)
    di, g, n = cfg.d_inner, cfg.n_groups, cfg.d_state
    xs = conv_out[..., :di]
    b = conv_out[..., di:di + g * n]
    c = conv_out[..., di + g * n:]

    H, P = cfg.n_heads, cfg.d_head
    xh = xs.reshape(B, Lx, H, P).float()
    bg = b.reshape(B, Lx, g, n).float()
    cg = c.reshape(B, Lx, g, n).float()
    dtp = F.softplus(dt.float() + lp["dt_bias"])
    a = -torch.exp(lp["a_log"])

    if streaming and Lx == 1:
        # O(1) recurrence
        rep = H // g
        bh = torch.repeat_interleave(bg[:, 0], rep, dim=1)  # (B,H,N)
        ch = torch.repeat_interleave(cg[:, 0], rep, dim=1)
        dec = torch.exp(dtp[:, 0] * a)
        h_new = ssm_state * dec[..., None, None] + torch.einsum(
            "bhn,bhp,bh->bhpn", bh, xh[:, 0], dtp[:, 0])
        y = torch.einsum("bhn,bhpn->bhp", ch, h_new)[:, None]
        new_ssm = h_new
    else:
        y, new_ssm = ssd_chunked(xh, dtp, a, bg, cg, cfg.chunk, ssm_state)

    y = y + lp["d_skip"][:, None] * xh               # D skip
    y = y.reshape(B, Lx, di).to(dt_c)
    y = L.rmsnorm(lp["gate_norm"], y * F.silu(z))
    out = y @ lp["out_proj"].to(dt_c)
    return x + out, new_conv, new_ssm


def backbone(params: dict, cfg: MambaConfig, tokens: torch.Tensor
             ) -> torch.Tensor:
    x = L.embed(params["embed"], tokens, cfg.compute_dtype)

    def body(lp, x):
        return _layer_fwd(lp, cfg, x)[0]

    body = L.block_remat(body, cfg)
    x = shd.constrain(x, "carry")
    for i in optrace.trips("layers", cfg.n_layers):
        x = shd.constrain(body(L.block_view(params["layers"], i), x),
                          "carry")
    return L.rmsnorm(params["final_norm"], x)


def loss_fn(params: dict, cfg: MambaConfig, tokens: torch.Tensor,
            targets: torch.Tensor) -> torch.Tensor:
    h = backbone(params, cfg, tokens)
    return L.chunked_xent(h, params["head"]["unembed"], targets,
                          cfg.loss_chunk)


def init_caches(cfg: MambaConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, *, device) -> dict:
    del max_len  # O(1) state — the whole point
    nl = cfg.n_layers
    return {
        "conv": torch.zeros((nl, batch, cfg.conv_width - 1, cfg.conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((nl, batch, cfg.n_heads, cfg.d_head,
                            cfg.d_state), dtype=torch.float32, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def decode_step(params: dict, cfg: MambaConfig, token: torch.Tensor,
                caches: dict):
    """One token through the O(1) recurrence; ``caches`` updated in place.
    Returns (logits (B, vocab) fp32, caches)."""
    x = L.embed(params["embed"], token, cfg.compute_dtype)
    if caches["conv"].dtype != x.dtype:
        # the reference's scan returns the new conv tails in the compute
        # dtype, so from the first step on its conv cache has that dtype
        caches["conv"] = caches["conv"].to(x.dtype)
    conv, ssm = caches["conv"], caches["ssm"]
    for i in optrace.trips("layers", cfg.n_layers):
        x, nc, ns = _layer_fwd(L.block_view(params["layers"], i), cfg, x,
                               conv[i], ssm[i], streaming=True)
        conv[i].copy_(nc)
        ssm[i].copy_(ns)
    caches["pos"].add_(1)
    h = L.rmsnorm(params["final_norm"], x)
    return L.unembed(params["head"], h)[:, 0], caches


def prefill(params: dict, cfg: MambaConfig, tokens: torch.Tensor):
    h = backbone(params, cfg, tokens)
    return L.unembed(params["head"], h[:, -1:])[:, 0], h

