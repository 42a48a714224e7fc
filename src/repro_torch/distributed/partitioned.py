"""Partitioned forms of the LM models' sharded sites: a per-shard body and
the collectives it needs, run under ``local_map`` on DTensors.

The reference gets these forms from its compiler: GSPMD partitions each op
of the step over the mesh and moves data where the layouts meet. DTensor
places each op on its own, and at these sites of the port's models its
choice is to gather a sharded operand whole. Here each site has the form
GSPMD gives the reference's:

``ssd_chunked``
    the Mamba-2 SSD chunk loop when its operands are split over the
    sequence: one all-to-all moves ``x`` and ``dt`` to a split by head
    (heads over ``model`` as far as they divide it, each head's P columns
    over the rest), the group-shared ``b`` and ``c`` are taken whole, the
    loop runs on the shard's heads over the whole sequence, and a second
    all-to-all returns ``y`` to the sequence split.
``decode_softmax``, ``pruned_decode_softmax``, ``index_write``
    one token's attention over a KV cache whose slots are split over
    ``model``: scores on the shard's slots, then the partial max, the
    partial sum of exponentials and the partial P.V all-reduced; the new
    token's row is written by the shard that holds its slot. The cache
    stays in place.
``xent_sum``, ``embed``
    the vocab-split unembedding and embedding: the cross-entropy's local
    max and sum of exponentials and a masked local gather of the gold
    logit, each all-reduced (the backward of the sums is the identity:
    every shard holds the same loss); the lookup by the shards' own rows
    or by the table moved to a split of its columns, whichever moves fewer
    bytes.
``moe_ffn``
    the MoE layer with its experts split over ``model``: each (token, k)
    row goes to the shard that owns its expert slot by all-to-all and
    comes back the same way for the combine. With experts over ``model``
    (EP) a slot's owner is its expert's shard and its capacity row's
    ``data`` shard; with each expert's F columns over ``model`` (TP) the
    capacity rows alone are split over ``data`` and every ``model`` shard
    of the owning row computes its F columns. Capacity, drops and ranks
    are ``moe.build_dispatch``'s, over the global token order.

A site enters its form only when its operand is a DTensor whose
placements split the axis in question over a mesh dimension named
``model`` (``splits``, ``ssd_splits``, ``embed_splits``,
``moe_splits``); a plain tensor never reaches this module, so every path
on one device is unchanged. A collective that fails raises: no form falls
back to gathering.

The collectives are ``torch.distributed._functional_collectives``, so the
dry run's recorder sees them as what they are; their autograd is this
module's own (``_AllToAll``, ``_SumOfReplicas``, ``_GatherReplicas``,
``_ReduceScatterColumns``), written for the placements the forms give
their results. The all-to-all of the MoE rows needs the rows each shard
sends to each other shard: on real tensors they are counted and exchanged
first (a host sync); on ``meta`` tensors (the dry run) the rows are taken
as spread evenly, which moves the same bytes.
"""
from __future__ import annotations

import math

import torch


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------


def _model_dim(t) -> int | None:
    """The index of ``t``'s mesh dimension named ``model``, or None."""
    names = t.device_mesh.mesh_dim_names or ()
    return names.index("model") if "model" in names else None


def splits(t, dim: int) -> bool:
    """Whether ``t`` is a DTensor split along ``dim`` over its mesh's
    ``model`` dimension, every other mesh dimension replicating it or
    splitting its leading (batch or token) dimension."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(t, DTensor):
        return False
    md = _model_dim(t)
    if md is None or t.device_mesh.size(md) == 1:
        return False
    if t.placements[md] != Shard(dim % t.ndim):
        return False
    return all(i == md or p == Replicate() or p == Shard(0)
               for i, p in enumerate(t.placements))


def _with_model(placements, md: int, p) -> tuple:
    """``placements`` with ``p`` on mesh dimension ``md``."""
    out = list(placements)
    out[md] = p
    return tuple(out)


def _to(t, placements):
    """DTensor ``t`` redistributed to ``placements`` (``t`` when it has
    them)."""
    placements = tuple(placements)
    return t if tuple(t.placements) == placements else t.redistribute(
        t.device_mesh, placements)


def _placed(t, mesh, placements=None):
    """``t`` as a DTensor on ``mesh`` with ``placements`` (replicated
    when None; a plain tensor is taken as every shard's copy)."""
    from torch.distributed.tensor import DTensor, Replicate
    rep = (Replicate(),) * mesh.ndim
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, rep, run_check=False)
    return _to(t, rep if placements is None else placements)


# ---------------------------------------------------------------------------
# collectives, with the autograd the forms' placements need
# ---------------------------------------------------------------------------


def _wait(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed._functional_collectives import (
        AsyncCollectiveTensor)
    return t.wait() if isinstance(t, AsyncCollectiveTensor) else t


def _all_to_all(x, out_splits, in_splits, group) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol
    return _wait(funcol.all_to_all_single(x.contiguous(), out_splits,
                                          in_splits, group))


def _all_reduce(x, op: str, group) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol
    return _wait(funcol.all_reduce(x.contiguous(), op, group))


def _all_gather(x, group) -> torch.Tensor:
    """The shards' ``x`` stacked along a new leading dimension."""
    from torch.distributed import _functional_collectives as funcol
    n = torch.distributed.get_world_size(group)
    gather = getattr(funcol, "all_gather_single", None) or \
        funcol.all_gather_tensor        # the older name
    out = _wait(gather(x.contiguous(), 0, group))
    return out.reshape(n, *x.shape)


class _AllToAll(torch.autograd.Function):
    """All-to-all of the rows of ``x``; the backward sends the gradient's
    rows back the way they came."""

    @staticmethod
    def forward(ctx, x, out_splits, in_splits, group):
        ctx.args = (in_splits, out_splits, group)
        return _all_to_all(x, out_splits, in_splits, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, *ctx.args), None, None, None


class _SumOfReplicas(torch.autograd.Function):
    """The all-reduced sum of the shards' partials, a value every shard
    then holds alike; so the gradient of each partial is the replicated
    gradient itself."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherReplicas(torch.autograd.Function):
    """The shards' pieces stacked along a new leading dimension, a value
    every shard then holds alike; the gradient of a piece is its own
    entry of the replicated gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.args = (torch.distributed.get_rank(group), group)
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.args[0]], None


class _ReduceScatterColumns(torch.autograd.Function):
    """The shards' partials summed, each shard keeping its block of the
    last dimension; the backward gathers the blocks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        from torch.distributed import _functional_collectives as funcol
        ctx.group = group
        scatter = getattr(funcol, "reduce_scatter_single", None) or \
            funcol.reduce_scatter_tensor    # the older name
        return _wait(scatter(x.contiguous(), "sum", x.ndim - 1, group))

    @staticmethod
    def backward(ctx, grad):
        parts = _all_gather(grad, ctx.group)          # (n, ..., d / n)
        return torch.cat(list(parts), dim=-1), None


# ---------------------------------------------------------------------------
# the SSD chunk loop over heads
# ---------------------------------------------------------------------------


def ssd_head_split(n: int, n_heads: int, d_head: int, n_groups: int):
    """``(hs, ps)``: the ``n`` shards of a ``model`` axis as ``hs`` head
    blocks times ``ps`` blocks of each head's P columns, or None when
    they do not divide (or a head block would straddle B/C groups)."""
    hs = math.gcd(n_heads, n)
    ps = n // hs
    per_group = n_heads // n_groups
    hh = n_heads // hs
    if d_head % ps or (hh % per_group and per_group % hh):
        return None
    return hs, ps


def ssd_splits(x, dt, b, c) -> bool:
    """Whether the SSD scan takes its partitioned form: one of ``x``
    (B, L, H, P), ``dt``, ``b``, ``c`` split over the sequence on
    ``model`` (which torch version's strategies split which of them
    differs), ``x`` a DTensor split on other mesh dimensions over the
    batch at most, and the shards dividing into head and P blocks
    (``ssd_head_split``)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor) or not any(
            splits(t, 1) for t in (x, dt, b, c)):
        return False
    md = _model_dim(x)
    n = x.device_mesh.size(md)
    if x.shape[1] % n or any(q not in (Replicate(), Shard(0))
                             for i, q in enumerate(x.placements) if i != md):
        return False
    return ssd_head_split(n, x.shape[2], x.shape[3], b.shape[2]) is not None


def ssd_chunked(scan, x, dt, a, b, c, chunk: int, h0=None):
    """``scan`` (``models/mamba2._ssd_scan``) on a shard's heads. x
    (B,L,H,P) and dt (B,L,H), split over the sequence on ``model`` first
    if they are not (a replicated operand's own slice: nothing moves); a
    (H,); b, c (B,L,G,N); h0 (B,H,P,N) or None. Returns (y (B,L,H,P)
    split over the sequence on ``model``, h_final (B,H,P,N) replicated
    over ``model``), both split over the batch as ``x``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    md = _model_dim(x)
    n = mesh.size(md)
    B, Lx, H, P = x.shape
    G = b.shape[2]
    hs, ps = ssd_head_split(n, H, P, G)
    hh, pp = H // hs, P // ps
    xpl = _with_model(x.placements, md, Shard(1))
    whole = _with_model(xpl, md, Replicate())     # batch split, model whole
    part = _with_model(xpl, md, Partial())
    group = mesh.get_group(md)
    x, dt = _to(x, xpl), _placed(dt, mesh, xpl)
    b, c = _placed(b, mesh, whole), _placed(c, mesh, whole)
    a = _placed(a, mesh)
    rep = (Replicate(),) * mesh.ndim
    args = [x, dt, a, b, c]
    in_pl = [xpl, xpl, rep, whole, whole]
    grad_pl = [xpl, xpl, (Partial(),) * mesh.ndim, part, part]
    if h0 is not None:
        args.append(_placed(h0, mesh, whole))
        in_pl.append(whole)
        grad_pl.append(part)

    def body(x, dt, a, b, c, h0=None):
        r = mesh.get_local_rank(md)
        ri, rp = divmod(r, ps)                   # this shard's blocks
        nb, ll = x.shape[0], x.shape[1]
        # x and dt (dt as one more column of each P block) to the head
        # split: piece j of the send buffer is shard j's blocks
        xs = x.reshape(nb, ll, hs, hh, ps, pp).permute(2, 4, 0, 1, 3, 5)
        ds = dt.reshape(nb, ll, hs, hh).permute(2, 0, 1, 3)[:, None, ...,
                                                            None]
        send = torch.cat([xs, ds.expand(hs, ps, nb, ll, hh, 1)], dim=-1)
        got = _AllToAll.apply(send.reshape(n, nb, ll, hh, pp + 1), None,
                              None, group)
        got = got.permute(1, 0, 2, 3, 4).reshape(nb, n * ll, hh, pp + 1)
        xl, dtl = got[..., :pp], got[..., pp]
        per_group = H // G
        g0, gn = (ri * hh) // per_group, max(hh // per_group, 1)
        hl = None if h0 is None else h0[:, ri * hh:(ri + 1) * hh,
                                        rp * pp:(rp + 1) * pp]
        y, hf = scan(xl.contiguous(), dtl.contiguous(),
                     a[ri * hh:(ri + 1) * hh], b[:, :, g0:g0 + gn],
                     c[:, :, g0:g0 + gn], chunk, hl)
        # y back to the sequence split: piece j is shard j's positions
        back = _AllToAll.apply(
            y.reshape(nb, n, ll, hh, pp).permute(1, 0, 2, 3, 4), None, None,
            group)
        y = back.reshape(hs, ps, nb, ll, hh, pp).permute(
            2, 3, 0, 4, 1, 5).reshape(nb, ll, H, P)
        hf = _GatherReplicas.apply(hf, group)     # (n, nb, hh, pp, N)
        hf = hf.reshape(hs, ps, *hf.shape[1:]).permute(2, 0, 3, 1, 4, 5)
        return y, hf.reshape(nb, H, P, hf.shape[-1])

    return local_map(body, out_placements=(xpl, whole),
                     in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl),
                     device_mesh=mesh)(*args)


# ---------------------------------------------------------------------------
# decode softmax over a sequence-sharded cache
# ---------------------------------------------------------------------------


def _softcap(s, cap):
    return s if cap is None else torch.tanh(s / cap) * cap


def _softmax_pv(s, v, group, cache_upcast: bool):
    """softmax(s) . v over key slots split across ``group``: s
    (b,kv,g,t) the local slots' masked scores, v (b,t,kv,hd). The max,
    the sum of exponentials and P.V are all-reduced."""
    m = _all_reduce(torch.amax(s, dim=-1), "max", group)
    e = torch.exp(s - m[..., None])
    attn = e / _all_reduce(torch.sum(e, dim=-1), "sum", group)[..., None]
    if not cache_upcast:
        attn = attn.to(v.dtype).float()
    pv = torch.einsum("bngt,btnd->bngd", attn, v.float())
    return _all_reduce(pv, "sum", group)


def decode_softmax(qg, ck, cv, bias, valid, cfg):
    """``decode_attention``'s softmax and P.V on the cache's own shards.
    qg (B,kv,g,hd); ck, cv (B,S,kv,hd) split over S on ``model``; bias
    (1,S) the additive mask and valid (S,) the written slots, both whole.
    Returns (B,kv,g,hd), split as the cache's batch."""
    from torch.distributed.tensor import Replicate
    from repro_torch.models.layers import NEG_INF
    from torch.distributed.tensor.experimental import local_map
    mesh = ck.device_mesh
    md = _model_dim(ck)
    group = mesh.get_group(md)
    kpl = tuple(ck.placements)
    qpl = _with_model(kpl, md, Replicate())
    rep = (Replicate(),) * mesh.ndim
    scale = math.sqrt(cfg.d_head)

    def body(qg, ck, cv, bias, valid):
        sl = ck.shape[1]
        lo = mesh.get_local_rank(md) * sl
        if not cfg.cache_upcast:
            qg = qg.to(ck.dtype)
        s = torch.einsum("bngd,btnd->bngt", qg.float(), ck.float()) / scale
        s = _softcap(s, cfg.softcap) + bias[:, None, None, lo:lo + sl]
        s = torch.where(valid[None, None, None, lo:lo + sl], s, NEG_INF)
        return _softmax_pv(s, cv, group, cfg.cache_upcast)

    return local_map(body, out_placements=list(qpl),
                     in_placements=(qpl, kpl, kpl, rep, rep),
                     device_mesh=mesh)(
        _placed(qg, mesh, qpl), ck, cv, _placed(bias, mesh),
        _placed(valid, mesh))


def pruned_decode_softmax(qg, ck, cv, idx, valid, cfg):
    """``pruned_decode_attention``'s softmax and P.V over the kept slots
    ``idx`` (keep,) of a cache split over S on ``model``: each shard
    scores the kept slots it holds, the others masked. qg (B,kv,g,hd);
    valid (keep,) the kept slots written so far."""
    from torch.distributed.tensor import Replicate
    from repro_torch.models.layers import NEG_INF
    from torch.distributed.tensor.experimental import local_map
    mesh = ck.device_mesh
    md = _model_dim(ck)
    group = mesh.get_group(md)
    kpl = tuple(ck.placements)
    qpl = _with_model(kpl, md, Replicate())
    rep = (Replicate(),) * mesh.ndim
    scale = math.sqrt(cfg.d_head)

    def body(qg, ck, cv, idx, valid):
        sl = ck.shape[1]
        local = idx - mesh.get_local_rank(md) * sl
        mine = (local >= 0) & (local < sl)
        local = torch.where(mine, local, 0)
        k_sel, v_sel = ck.index_select(1, local), cv.index_select(1, local)
        qg = qg.to(k_sel.dtype)
        s = torch.einsum("bngd,btnd->bngt", qg.float(),
                         k_sel.float()) / scale
        s = _softcap(s, cfg.softcap)
        s = torch.where((valid & mine)[None, None, None, :], s, NEG_INF)
        return _softmax_pv(s, v_sel, group, False)

    return local_map(body, out_placements=list(qpl),
                     in_placements=(qpl, kpl, kpl, rep, rep),
                     device_mesh=mesh)(
        _placed(qg, mesh, qpl), ck, cv, _placed(idx, mesh),
        _placed(valid, mesh))


def index_write(c, dim: int, index, new) -> None:
    """``c.index_copy_(dim, index, new)`` on a DTensor ``c``, in place, as
    each shard's local update (not every torch has a DTensor strategy for
    ``index_copy_``). When ``c`` is split along ``dim`` on ``model`` (a
    cache's slots) the shard that holds the slot writes it and every
    other rewrites one of its own slots with its own value: nothing of
    ``c`` moves. ``index`` holds one slot."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = c.device_mesh
    md = _model_dim(c)
    local = c.to_local()
    at = _placed(index, mesh).to_local()
    split = md is not None and c.placements[md] == Shard(dim)
    new = _placed(new, mesh, _with_model(c.placements, md, Replicate())
                  if split else c.placements).to_local().to(local.dtype)
    if not split:
        local.index_copy_(dim, at, new)
        return
    sl = local.shape[dim]
    at = at - mesh.get_local_rank(md) * sl
    mine = (at >= 0) & (at < sl)
    at = torch.where(mine, at, 0)
    keep = mine.reshape((1,) * dim + (-1,) + (1,) * (local.ndim - dim - 1))
    local.index_copy_(dim, at, torch.where(keep, new,
                                           local.index_select(dim, at)))


def embed_splits(table) -> bool:
    """Whether ``table[tokens]`` takes ``embed``: a table (V, D) split over
    V on ``model``, whose shards divide D."""
    return splits(table, 0) and \
        table.shape[1] % table.device_mesh.size(_model_dim(table)) == 0


def embed(table, tokens):
    """``table[tokens]`` of a table (V, D) split over V on ``model``,
    placed as ``tokens`` with D split on ``model`` (the layout DTensor
    gives the lookup) and the table never gathered. Of two forms, the one
    that moves fewer bytes: with fewer token rows than a shard's table
    rows (decode), each shard looks up the tokens it holds and the rows'
    columns are reduce-scattered; else (training, prefill) one all-to-all
    turns the table's split to D, and each shard looks up its columns."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    md = _model_dim(table)
    n = mesh.size(md)
    group = mesh.get_group(md)
    tokens = _placed(tokens, mesh, _with_model(
        getattr(tokens, "placements", (Replicate(),) * mesh.ndim), md,
        Replicate()))
    tpl = tuple(tokens.placements)
    wpl = tuple(table.placements)
    wgrad = tuple(q if i == md else Partial() if isinstance(tpl[i], Shard)
                  else q for i, q in enumerate(wpl))
    rows = math.prod(tokens.to_local().shape)
    by_rows = rows < table.shape[0] // n

    def body(w, t):
        vl, d = w.shape
        if by_rows:
            idx = t.long() - mesh.get_local_rank(md) * vl
            mine = (idx >= 0) & (idx < vl)
            got = torch.where(mine[..., None], w[torch.where(mine, idx, 0)],
                              0.0)
            return _ReduceScatterColumns.apply(got, group)
        cols = _AllToAll.apply(w.reshape(vl, n, d // n).transpose(0, 1),
                               None, None, group)
        return cols.reshape(n * vl, d // n)[t.long()]

    return local_map(body,
                     out_placements=[Shard(tokens.ndim) if i == md else q
                                     for i, q in enumerate(tpl)],
                     in_placements=(wpl, tpl),
                     in_grad_placements=(wgrad, tpl), device_mesh=mesh)(
        table, tokens)


# ---------------------------------------------------------------------------
# vocab-parallel cross-entropy
# ---------------------------------------------------------------------------


def xent_sum(logits, targets):
    """Summed cross-entropy of fp32 ``logits`` (B,c,V) split over V on
    ``model`` against ``targets`` (B,c): the max, the sum of
    exponentials and the gold logit each all-reduced. A 0-d DTensor,
    partial over the mesh dimensions that split the batch."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    md = _model_dim(logits)
    group = mesh.get_group(md)
    lpl = tuple(logits.placements)
    tpl = _with_model(lpl, md, Replicate())
    out_pl = tuple(Partial() if isinstance(p, Shard) and i != md
                   else Replicate() for i, p in enumerate(lpl))

    def body(lg, t):
        vl = lg.shape[-1]
        m = _all_reduce(torch.amax(lg.detach(), dim=-1), "max", group)
        se = _SumOfReplicas.apply(
            torch.sum(torch.exp(lg - m[..., None]), dim=-1), group)
        lse = torch.log(se) + m
        idx = t.long() - mesh.get_local_rank(md) * vl
        mine = (idx >= 0) & (idx < vl)
        gold = torch.gather(lg, -1, torch.where(mine, idx, 0)[..., None])
        gold = _SumOfReplicas.apply(
            torch.where(mine, gold[..., 0], 0.0), group)
        return torch.sum(lse - gold)

    return local_map(body, out_placements=list(out_pl),
                     in_placements=(lpl, tpl),
                     in_grad_placements=(lpl, tpl), device_mesh=mesh)(
        logits, _placed(targets, mesh, tpl))


# ---------------------------------------------------------------------------
# MoE: rows to their experts' shards by all-to-all
# ---------------------------------------------------------------------------


def _moe_tokens(p: dict, x):
    """The placements ``moe_ffn``'s form takes its tokens ``x`` (T, D) in:
    split over the data dimensions as far as they divide T, and on
    ``model`` whole (TP: every model shard of a row computes its F
    columns) or split (EP: each model shard routes its own block). None
    when the form does not apply: the mesh's last dimension is not
    ``model`` (a shard's block of tokens is innermost), it splits
    neither the experts nor their F columns, or (EP) the tokens of a
    data shard do not split over it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor) or x.ndim != 2:
        return None
    mesh, md, w = x.device_mesh, _model_dim(x), p["w_gate"]
    if md != mesh.ndim - 1 or not isinstance(w, DTensor) or \
            w.placements[md] not in (Shard(0), Shard(2)):
        return None
    names, ways, target = mesh.mesh_dim_names, 1, []
    for i, q in enumerate(x.placements[:md]):
        if (q == Shard(0) or names[i] in ("pod", "data")) and \
                x.shape[0] % (ways * mesh.size(i)) == 0:
            ways *= mesh.size(i)
            target.append(Shard(0))
        else:
            target.append(Replicate())
    if w.placements[md] == Shard(2):
        return tuple(target) + (Replicate(),)
    if x.shape[0] % (ways * mesh.size(md)):
        return None
    return tuple(target) + (Shard(0),)


def moe_splits(p: dict, x) -> bool:
    """Whether ``moe_ffn`` takes its partitioned form: tokens ``x`` (T, D)
    a DTensor on a mesh whose last dimension, ``model``, splits the
    experts (E, EP) or each expert's F columns (TP) (``_moe_tokens``)."""
    return _moe_tokens(p, x) is not None


def _even(rows: int, n: int) -> list:
    """``rows`` spread over ``n`` shards as evenly as they go."""
    return [rows // n + (i < rows % n) for i in range(n)]


def _send(rows, meta, dest, n: int, group):
    """Rows (R, D) and their int metadata (R, m) to shard ``dest`` of
    ``group``: (rows, metadata received, how to send rows back)."""
    order = torch.sort(dest, stable=True).indices
    rows, meta = rows[order], meta[order]
    if dest.is_meta:       # a dry run: no routing to count
        sent = got = _even(dest.shape[0], n)
    else:
        counts = torch.bincount(dest, minlength=n)
        sent = counts.tolist()
        got = _all_to_all(counts, None, None, group).tolist()
    return (_AllToAll.apply(rows, got, sent, group),
            _all_to_all(meta, got, sent, group), (order, sent, got))


def _send_back(rows, how, group):
    """The inverse of ``_send`` for rows computed on the received ones."""
    order, sent, got = how
    return _AllToAll.apply(rows, sent, got, group)[torch.argsort(order)]


def moe_ffn(p: dict, x, top_k: int, *, capacity_factor: float = 1.25,
            act: str = "silu"):
    """``models/moe.moe_ffn`` on tokens ``x`` (T, D), the experts split
    over ``model`` (see the module docstring). Returns (T, D): split over
    T as the tokens are taken (``_moe_tokens``), and on ``model`` over T
    (EP) or as partial sums of the F columns (TP)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.models import moe as M
    mesh = x.device_mesh
    md = _model_dim(x)
    n_m = mesh.size(md)
    T, D = x.shape
    E = p["router"].shape[1]
    C = M.capacity(T, E, top_k, capacity_factor)
    ep = p["w_gate"].placements[md] == Shard(0)
    names = mesh.mesh_dim_names
    x = _to(x, _moe_tokens(p, x))
    xpl = tuple(x.placements)
    tok = [i for i, q in enumerate(xpl) if i != md and q == Shard(0)]
    # the capacity rows split over "data" when it splits the tokens
    dd = names.index("data") if "data" in names else None
    n_c = mesh.size(dd) if dd in tok and C % mesh.size(dd) == 0 else 1
    cl = C // n_c
    blocks = tok + ([md] if ep else [])     # the shards' token blocks
    el = E // n_m if ep else E

    def weight_pl(f_dim):
        return tuple((Shard(0) if ep else Shard(f_dim)) if i == md
                     else Replicate() for i in range(mesh.ndim))

    def weight_grad_pl(f_dim):
        return tuple((Shard(0) if ep else Shard(f_dim)) if i == md
                     else Partial() if i in tok else Replicate()
                     for i in range(mesh.ndim))

    rep = (Replicate(),) * mesh.ndim
    router_grad = tuple(Partial() if i in tok or i == md else Replicate()
                        for i in range(mesh.ndim))
    x_grad = xpl if ep else _with_model(xpl, md, Partial())
    out_pl = xpl if ep else _with_model(xpl, md, Partial())

    def body(x, router, w_gate, w_up, w_down):
        coord = {i: mesh.get_local_rank(i) for i in blocks}
        tl = x.shape[0]
        idx, probs = M.route(router, x, top_k)
        flat_e = idx.reshape(-1).long()
        rank, counts = M.expert_ranks(flat_e, E)
        # the global rank: the assignments of the blocks before this one,
        # in the flat token order (the blocks' mesh order, major first)
        for i in reversed(blocks):
            counts = _all_gather(counts, mesh.get_group(i))
        before = 0
        for i in blocks:
            before = before * mesh.size(i) + coord[i]
        counts = counts.reshape(-1, E)
        rank = rank + counts[:before].sum(0)[flat_e]
        keep = rank < C
        rows = x[torch.arange(tl * top_k, device=x.device) // top_k]
        meta = torch.stack([flat_e, rank], dim=1)
        sel = None
        if not x.is_meta:          # dropped rows are not sent
            sel = keep.nonzero().squeeze(1)
            rows, meta = rows[sel], meta[sel]
        hops = []
        if ep:
            rows, meta, how = _send(rows, meta, meta[:, 0] // el, n_m,
                                    mesh.get_group(md))
            hops.append((how, md))
        if n_c > 1:
            rows, meta, how = _send(rows, meta, meta[:, 1] // cl, n_c,
                                    mesh.get_group(dd))
            hops.append((how, dd))
        # this shard's slots of the dispatch table, the experts on them
        e_loc = meta[:, 0] - (mesh.get_local_rank(md) * el if ep else 0)
        r_loc = meta[:, 1] - (mesh.get_local_rank(dd) * cl if n_c > 1
                              else 0)
        table = torch.zeros((el, cl, D), dtype=x.dtype, device=x.device)
        table = table.index_put((e_loc, r_loc), rows)
        out = M.experts({"w_gate": w_gate, "w_up": w_up, "w_down": w_down},
                        table, act)
        rows = out[e_loc, r_loc]
        for how, i in reversed(hops):
            rows = _send_back(rows, how, mesh.get_group(i))
        if sel is not None:
            rows = torch.zeros((tl * top_k, D), dtype=rows.dtype,
                               device=rows.device).index_copy(0, sel, rows)
        return M.combine(rows, probs, keep.reshape(tl, top_k)).to(x.dtype)

    return local_map(
        body, out_placements=list(out_pl),
        in_placements=(xpl, rep, weight_pl(2), weight_pl(2), weight_pl(1)),
        in_grad_placements=(x_grad, router_grad, weight_grad_pl(2),
                            weight_grad_pl(2), weight_grad_pl(1)),
        device_mesh=mesh)(
        x, _placed(p["router"], mesh), _placed(p["w_gate"], mesh,
                                               weight_pl(2)),
        _placed(p["w_up"], mesh, weight_pl(2)),
        _placed(p["w_down"], mesh, weight_pl(1)))
