"""Entry points of the port's four kernels, at the reference's native dims.

Counterpart of ``repro.kernels.ops``. Each entry point takes tensors at
the model's own widths (f_mem = 100, f_edge = 172, ...; nothing is padded
to the TPU's 128 lanes: the CUDA kernels mask their own ragged edges):

  lut_encode     kernels/csrc/lut_encode.cu     lut_encode_pallas
  gru_cell       kernels/csrc/gru_cell.cu       gru_cell_pallas
  sat_aggregate  kernels/csrc/sat_aggregate.cu  sat_aggregate_pallas
  fused_step     kernels/csrc/fused_step.cu     fused_step_pallas

Beside each one is its plain PyTorch version (``*_plain``), with the
semantics of ``repro.kernels.ref``. An entry point given CPU tensors runs
the plain version; given CUDA tensors it checks them and launches the
kernel on the current stream, or raises. It never falls back.

``LAUNCHES`` counts launches per entry point: one for each call that
launches its kernels (``fused_step``'s three back-to-back kernels are
one call, as in the reference), so a run can show that its main path went
through the kernels.

Under the op-trace recorder (``launch/hlo_analysis.record``) each entry
point is one opaque entry charged the tensors its kernel reads and the
results it writes, on the card and on the CPU alike (the plain version's
inner ops are not recorded); without one it costs one module-level test.

Rows are independent in every kernel: an output row depends only on its
own inputs. So a cohort of T tenants (``TGNPipeline.batched_step``) calls
each entry point once over the T·2B rows of all its tenants, with vertex
ids offset into stacked (T·V + 1, ...) tables. Ids are int32 and a grid's
y dimension holds at most 65,535 blocks; the entry points check both.
"""
from __future__ import annotations

import torch

from repro_torch.obs import optrace
from repro_torch.utils import NEG_INF

#: kernel launches per entry point since the last ``reset_launch_counts``.
LAUNCHES = {"lut_encode": 0, "gru_cell": 0, "sat_aggregate": 0,
            "fused_step": 0}

#: the kernels take at most this many winners per row (16 warps a block).
MAX_K = 16


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def _check_cuda(device: torch.device, **tensors) -> None:
    """Every tensor the kernel reads or writes: on ``device``, contiguous,
    and of the dtype the kernel takes (given as ``name=(tensor, dtype)``)."""
    for name, (t, dtype) in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_shape(name: str, t: torch.Tensor, shape: tuple) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


#: the largest grid.y of a launch; rows ride on grid.y in gru_cell,
#: sat_aggregate and the three fused_step kernels
MAX_GRID_Y = 65535
#: rows a block of rt::gru_update (kGruRows) and of the output transform
#: (OutShape::kRows); the EU's block takes EU_MTILES m16 tiles of k-row
#: groups (kEuMTiles)
GRU_ROWS, OUT_ROWS, EU_MTILES = 16, 16, 2


def _check_grid_rows(name: str, rows: int, per_block: int) -> None:
    """``rows`` on grid.y at ``per_block`` rows a block must fit
    ``MAX_GRID_Y`` blocks."""
    blocks = -(-rows // per_block)
    if blocks > MAX_GRID_Y:
        raise ValueError(
            f"{name}: {rows} rows need {blocks} blocks on grid.y at "
            f"{per_block} rows a block; a launch takes at most "
            f"{MAX_GRID_Y} (at most {MAX_GRID_Y * per_block} rows)")


def _check_table_rows(name: str, t: torch.Tensor) -> None:
    """Rows of a table addressed by int32 ids (a cohort's stacked tables
    hold T·(V + 1) rows or fewer)."""
    if t.shape[0] >= 2 ** 31:
        raise ValueError(f"{name} has {t.shape[0]} rows; int32 ids address "
                         f"fewer than 2**31")


def eu_rows_per_block(k: int) -> int:
    """Batch rows a block of rt::sat_eu takes at k winners a row."""
    return EU_MTILES * (16 // k)


def _launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` on the current stream of ``device``;
    tensors pass as device pointers, ints as ints."""
    from repro_torch.kernels import build
    fn = getattr(build.library(), name)
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else
            (None if a is None else int(a)) for a in args]
    with torch.cuda.device(device):
        err = fn(*conv, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


F32, I32, BOOL = torch.float32, torch.int32, torch.bool


# ---------------------------------------------------------------------------
# Parameter packs (built once per model by core.stages.make_prepare)
# ---------------------------------------------------------------------------


def n_bounds(E: int) -> int:
    """Entries of the bounds of a table of E rows: E rounded up to whole
    float4s (rt::lut_buckets loads them 16 bytes at a time)."""
    return -(-E // 4) * 4


def sentinel_bounds(boundaries: torch.Tensor, E: int) -> torch.Tensor:
    """bounds (E-1,) -> (n_bounds(E),): +inf sentinels after the E-1
    boundaries, the one boundary layout every kernel's bucketing reads
    (rt::lut_buckets). A sentinel counts nothing for a finite dt, and the
    count is clamped to E-1, so the padding changes no bucket."""
    pad = torch.full((n_bounds(E) - boundaries.shape[0],), float("inf"),
                     dtype=F32, device=boundaries.device)
    return torch.cat([boundaries.to(F32), pad]).contiguous()


def _check_bounds(name: str, bounds: torch.Tensor, E: int) -> None:
    """Bounds in ``sentinel_bounds``'s layout for E table rows, 16-byte
    aligned."""
    _check_shape(name, bounds, (n_bounds(E),))
    if bounds.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(F32).contiguous()


def pack_lut_params(boundaries: torch.Tensor, table: torch.Tensor) -> dict:
    return {"bounds": sentinel_bounds(boundaries, table.shape[0]),
            "table": _f32(table)}


#: the GRU tile of rt::gru_update (common.cuh): output columns per block
#: (kGruCols) and K per pipeline stage (kGruDepth).
GRU_COLS = 8
GRU_DEPTH = 64


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: what ``cvt.rna.tf32.f32`` gives, kept as fp32."""
    bits = x.to(F32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(F32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo + O(2^-22 |x|), hi and lo TF32 values: the operand
    split of the 3xTF32 product."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def gru_stages(F: int, M: int) -> tuple[int, int]:
    """(mail stages, memory stages) of the packed GRU depth."""
    return -(-F // GRU_DEPTH), -(-M // GRU_DEPTH)


def pack_gru_tc(w_i: torch.Tensor, w_h: torch.Tensor) -> torch.Tensor:
    """The tensor-core layout of the GRU weights that rt::gru_update
    streams: (NT, S, 2, GRU_DEPTH, 3 * GRU_COLS), for column tile j and
    depth stage s the TF32 high part, then the low part, of that stage's
    rows, each row the [r | z | n] columns of the tile. The mail rows
    (w_i) fill the first Sf stages, the memory rows (w_h) the next Sm;
    rows past F or M and columns past M are 0."""
    F, M = w_i.shape[0], w_h.shape[0]
    sf, sm = gru_stages(F, M)
    nt = -(-M // GRU_COLS)
    w = torch.zeros(((sf + sm) * GRU_DEPTH, 3, nt * GRU_COLS), dtype=F32,
                    device=w_i.device)
    w[:F, :, :M] = w_i.to(F32).reshape(F, 3, M)
    w[sf * GRU_DEPTH:sf * GRU_DEPTH + M, :, :M] = w_h.to(F32).reshape(M, 3, M)
    w = w.reshape(sf + sm, GRU_DEPTH, 3, nt, GRU_COLS).permute(3, 0, 1, 2, 4)
    hi, lo = tf32_split(w.reshape(nt, sf + sm, GRU_DEPTH, 3 * GRU_COLS))
    return torch.stack([hi, lo], dim=2).contiguous()


def pack_gru_params(w_i: torch.Tensor, w_h: torch.Tensor, b_i: torch.Tensor,
                    b_h: torch.Tensor) -> dict:
    """w_i (F, 3M) raw-mail rows, w_h (M, 3M), biases (3M,); gate blocks
    [r | z | n] at f_mem strides, as in the core layout. The plain
    versions read these; the kernels read ``w_tc`` (``pack_gru_tc``) and
    the biases."""
    return {"w_i": _f32(w_i), "w_h": _f32(w_h), "b_i": _f32(b_i),
            "b_h": _f32(b_h), "w_tc": pack_gru_tc(w_i, w_h)}


def _check_gru_tc(w_tc: torch.Tensor, F: int, M: int) -> None:
    sf, sm = gru_stages(F, M)
    _check_shape("w_tc", w_tc, (-(-M // GRU_COLS), sf + sm, 2, GRU_DEPTH,
                                3 * GRU_COLS))


#: the EU tile of rt::sat_eu (EuShape in common.cuh; sat_aggregate and
#: fused_step phase 1) and the output transform's tile (OutShape): output
#: columns a block and K per pipeline stage.
EU_COLS, EU_DEPTH = 56, 64
OUT_COLS, OUT_DEPTH = 8, 64


def pack_rows_tc(parts, depth: int, cols: int) -> torch.Tensor:
    """The tensor-core layout of W = [parts[0]; parts[1]; ...] (each
    (rows_p, N)) that rt::tc_tile streams: (NT, S, 2, depth, cols), for
    column tile j and depth stage s the TF32 high part, then the low part,
    of that stage's rows. Each part's rows are padded to whole stages, so
    a stage reads one source; rows and columns of padding are 0."""
    N = parts[0].shape[1]
    stages = [-(-p.shape[0] // depth) for p in parts]
    nt = -(-N // cols)
    w = torch.zeros((sum(stages) * depth, nt * cols), dtype=F32,
                    device=parts[0].device)
    r0 = 0
    for part, s in zip(parts, stages):
        w[r0:r0 + part.shape[0], :N] = part.to(F32)
        r0 += s * depth
    hi, lo = tf32_split(w.reshape(sum(stages), depth, nt, cols)
                        .permute(2, 0, 1, 3))
    return torch.stack([hi, lo], dim=2).contiguous()


def _check_rows_tc(name: str, w_tc: torch.Tensor, rows: tuple, N: int,
                   depth: int, cols: int) -> None:
    S = sum(-(-r // depth) for r in rows)
    _check_shape(name, w_tc, (-(-N // cols), S, 2, depth, cols))


def pack_sat_params(w_v: torch.Tensor, b_v: torch.Tensor,
                    boundaries: torch.Tensor,
                    folded_table: torch.Tensor) -> dict:
    """w_v (Dkv, D) memory||edge rows only; folded table (E, D) is
    table @ W_v[time rows]. The plain version reads ``w_v``; the kernel
    reads ``w_tc``, its layout for rt::sat_eu (``pack_rows_tc``: the kv
    rows as one source)."""
    return {"w_v": _f32(w_v), "b_v": _f32(b_v),
            "bounds": sentinel_bounds(boundaries, folded_table.shape[0]),
            "table": _f32(folded_table),
            "w_tc": pack_rows_tc([w_v], EU_DEPTH, EU_COLS)}


def pack_fused_params(gru_params: dict, attn_params: dict, folded_gru: dict,
                      folded_attn: dict, f_mail_raw: int, f_mem: int,
                      f_edge: int) -> dict:
    """Everything the fused step reads: the raw-mail GRU weights and the
    GRU-folded table (E, 3M); W_v's memory||edge rows (M + Fe, D) and the
    attention-folded table (E, D); the output transform (M + D, f_emb).
    The plain version reads the raw weights; the kernels read ``w_tc``
    (``pack_gru_tc``), ``wv_tc`` (W_v with its memory rows and its edge
    rows each padded to whole stages) and ``wout_tc`` (W_out with its
    s_upd rows and its aggregate rows each padded), laid out by
    ``pack_rows_tc``."""
    gru = pack_gru_params(gru_params["w_i"][:f_mail_raw], gru_params["w_h"],
                          gru_params["b_i"], gru_params["b_h"])
    E = folded_gru["table"].shape[0]
    w_v = _f32(attn_params["w_v"][:f_mem + f_edge])
    w_out = _f32(attn_params["w_out"])
    return {
        **gru,
        "g_bounds": sentinel_bounds(folded_gru["boundaries"], E),
        "g_table": _f32(folded_gru["table"]),
        "w_v": w_v,
        "b_v": _f32(attn_params["b_v"]),
        "s_bounds": sentinel_bounds(folded_attn["boundaries"], E),
        "s_table": _f32(folded_attn["table"]),
        "w_out": w_out,
        "b_out": _f32(attn_params["b_out"]),
        "wv_tc": pack_rows_tc([w_v[:f_mem], w_v[f_mem:]], EU_DEPTH, EU_COLS),
        "wout_tc": pack_rows_tc([w_out[:f_mem], w_out[f_mem:]], OUT_DEPTH,
                                OUT_COLS),
    }


# ---------------------------------------------------------------------------
# LUT time encode
# ---------------------------------------------------------------------------


def lut_encode_plain(dt: torch.Tensor, bounds: torch.Tensor,
                     table: torch.Tensor) -> torch.Tensor:
    """dt (n,), bounds (E,) with sentinel, table (E, D) -> (n, D)."""
    bucket = (dt[:, None] >= bounds[None, :]).sum(dim=1)
    return table[bucket.clamp(max=table.shape[0] - 1)]


def lut_encode(dt: torch.Tensor, packed: dict) -> torch.Tensor:
    """dt (...,) -> (..., D): the packed table's row of bucket(dt)."""
    bounds, table = packed["bounds"], packed["table"]
    if optrace.ACTIVE.recorder is not None:
        return optrace.ACTIVE.recorder.kernel(
            "lut_encode", lut_encode, (dt, packed), (dt, bounds, table))
    E, D = table.shape
    shape = dt.shape
    flat = dt.reshape(-1)
    if flat.device.type == "cpu":
        return lut_encode_plain(flat, bounds, table).reshape(*shape, D)
    _check_cuda(flat.device, dt=(flat, F32), bounds=(bounds, F32),
                table=(table, F32))
    _check_bounds("bounds", bounds, E)
    out = torch.empty((flat.shape[0], D), dtype=F32, device=flat.device)
    if flat.shape[0] == 0:                  # nothing to launch
        return out.reshape(*shape, D)
    _launch("rt_lut_encode", flat.device, flat, bounds, table, out,
            flat.shape[0], E, D)
    LAUNCHES["lut_encode"] += 1
    return out.reshape(*shape, D)


def lut_encode_floor(dt: torch.Tensor, packed: dict,
                     out: torch.Tensor) -> None:
    """Launch an empty kernel with ``lut_encode``'s grid, block and
    arguments on CUDA tensors (``out`` (n, D)): the launch floor that
    ``lut_encode``'s device time is read against. Counts no launch."""
    bounds, table = packed["bounds"], packed["table"]
    E, D = table.shape
    _launch("rt_noop", dt.device, dt, bounds, table, out, dt.shape[0], E, D)


# ---------------------------------------------------------------------------
# GRU memory update
# ---------------------------------------------------------------------------


def gru_cell_plain(mail: torch.Tensor, s: torch.Tensor, w_i: torch.Tensor,
                   w_h: torch.Tensor, b_i: torch.Tensor, b_h: torch.Tensor,
                   extra: torch.Tensor | None = None) -> torch.Tensor:
    M = s.shape[-1]
    gi = mail @ w_i + b_i
    if extra is not None:
        gi = gi + extra
    gh = s @ w_h + b_h
    r = torch.sigmoid(gi[:, :M] + gh[:, :M])
    z = torch.sigmoid(gi[:, M:2 * M] + gh[:, M:2 * M])
    n = torch.tanh(gi[:, 2 * M:] + r * gh[:, 2 * M:])
    return (1.0 - z) * n + z * s


def gru_cell(mail: torch.Tensor, s: torch.Tensor, packed: dict,
             extra: torch.Tensor | None = None) -> torch.Tensor:
    """Fused GRU cell. mail (n, F), s (n, M), ``packed`` from
    pack_gru_params, ``extra`` optional (n, 3M) additive input-gate rows
    (the LUT-folded time rows). Returns (n, M)."""
    w_i, w_h, b_i, b_h = (packed[k] for k in ("w_i", "w_h", "b_i", "b_h"))
    if optrace.ACTIVE.recorder is not None:
        return optrace.ACTIVE.recorder.kernel(
            "gru_cell", gru_cell, (mail, s, packed, extra),
            (mail, s, extra, packed["w_tc"], b_i, b_h))
    if mail.device.type == "cpu":
        return gru_cell_plain(mail, s, w_i, w_h, b_i, b_h, extra)
    n, F = mail.shape
    M = s.shape[1]
    dev = mail.device
    w_tc = packed["w_tc"]
    tensors = dict(mail=(mail, F32), s=(s, F32), w_tc=(w_tc, F32),
                   b_i=(b_i, F32), b_h=(b_h, F32))
    if extra is not None:
        tensors["extra"] = (extra, F32)
        _check_shape("extra", extra, (n, 3 * M))
    _check_cuda(dev, **tensors)
    _check_shape("s", s, (n, M))
    _check_shape("w_i", w_i, (F, 3 * M))
    _check_shape("w_h", w_h, (M, 3 * M))
    _check_gru_tc(w_tc, F, M)
    _check_shape("b_i", b_i, (3 * M,))
    _check_shape("b_h", b_h, (3 * M,))
    _check_grid_rows("gru_cell", n, GRU_ROWS)
    out = torch.empty((n, M), dtype=F32, device=dev)
    _launch("rt_gru_cell", dev, mail, s, extra, w_tc, b_i, b_h, out, n, F,
            M)
    LAUNCHES["gru_cell"] += 1
    return out


# ---------------------------------------------------------------------------
# SAT aggregation
# ---------------------------------------------------------------------------


def _softmax_fam_plain(logits: torch.Tensor, valid: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """Masked softmax over the k winners (invalid -> NEG_INF, a row with no
    valid winner gives zeros) and sum_k attn * v. logits/valid (n, k),
    v (n, k, D) -> (n, D)."""
    vf = valid.to(F32)
    masked = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    mx = masked.max(dim=1, keepdim=True).values
    e = torch.exp(masked - mx) * vf
    z = e.sum(dim=1, keepdim=True)
    attn = torch.where(z > 0, e / z.clamp(min=1e-30), torch.zeros_like(e))
    return (attn[:, :, None] * v).sum(dim=1)


def sat_aggregate_plain(kv: torch.Tensor, dt: torch.Tensor,
                        logits: torch.Tensor, valid: torch.Tensor,
                        w_v: torch.Tensor, b_v: torch.Tensor,
                        bounds: torch.Tensor,
                        table: torch.Tensor) -> torch.Tensor:
    B, k, dkv = kv.shape
    v = kv.reshape(B * k, dkv) @ w_v
    v = v + lut_encode_plain(dt.reshape(B * k), bounds, table)
    v = (v + b_v).reshape(B, k, -1)
    return _softmax_fam_plain(logits, valid, v)


def sat_aggregate(kv: torch.Tensor, dt: torch.Tensor, logits: torch.Tensor,
                  valid: torch.Tensor, packed: dict) -> torch.Tensor:
    """Student EU tail. kv (B, k, Dkv); dt/logits (B, k); valid (B, k)
    bool. Returns (B, D)."""
    w_v, b_v, bounds, table = (packed[n] for n in
                               ("w_v", "b_v", "bounds", "table"))
    if optrace.ACTIVE.recorder is not None:
        return optrace.ACTIVE.recorder.kernel(
            "sat_aggregate", sat_aggregate, (kv, dt, logits, valid, packed),
            (kv, dt, logits, valid, packed["w_tc"], b_v, bounds, table))
    if kv.device.type == "cpu":
        return sat_aggregate_plain(kv, dt, logits, valid, w_v, b_v, bounds,
                                   table)
    B, k, dkv = kv.shape
    E, D = table.shape
    dev = kv.device
    if not 1 <= k <= MAX_K:
        raise ValueError(f"sat_aggregate takes 1..{MAX_K} winners, got {k}")
    w_tc = packed["w_tc"]
    _check_cuda(dev, kv=(kv, F32), dt=(dt, F32), logits=(logits, F32),
                valid=(valid, BOOL), w_tc=(w_tc, F32), b_v=(b_v, F32),
                bounds=(bounds, F32), table=(table, F32))
    for name, t in (("dt", dt), ("logits", logits), ("valid", valid)):
        _check_shape(name, t, (B, k))
    _check_shape("w_v", w_v, (dkv, D))
    _check_rows_tc("w_tc", w_tc, (dkv,), D, EU_DEPTH, EU_COLS)
    _check_shape("b_v", b_v, (D,))
    _check_bounds("bounds", bounds, E)
    _check_grid_rows("sat_aggregate", B, eu_rows_per_block(k))
    out = torch.empty((B, D), dtype=F32, device=dev)
    _launch("rt_sat_aggregate", dev, kv, dt, logits, valid, w_tc, b_v,
            bounds, table, out, B, k, dkv, D, E)
    LAUNCHES["sat_aggregate"] += 1
    return out


# ---------------------------------------------------------------------------
# Fused single-pass step
# ---------------------------------------------------------------------------


#: the packed leaves ``fused_step``'s kernels read
FUSED_READS = ("w_tc", "b_i", "b_h", "g_bounds", "g_table", "wv_tc", "b_v",
               "s_bounds", "s_table", "wout_tc", "b_out")


def fused_step_plain(vids, sel_ids, sel_eid, hit, dt_mail, mail_ok, sel_dt,
                     sel_logits, sel_valid, memory, mail, edge_feats,
                     packed: dict):
    """Phase 0: LUT + GRU over the gathered mail/memory rows of ``vids``,
    s_prev kept where ``mail_ok`` is False. Phase 1: winners' memory rows
    (from phase 0 where ``hit >= 0``) || edge rows through W_v, folded LUT
    rows, masked softmax + FAM, then [s_upd || agg] @ W_out + b_out."""
    p = packed
    vids = vids.long()
    s_prev = memory[vids]
    extra = lut_encode_plain(dt_mail, p["g_bounds"], p["g_table"])
    s_new = gru_cell_plain(mail[vids], s_prev, p["w_i"], p["w_h"], p["b_i"],
                           p["b_h"], extra)
    s_upd = torch.where(mail_ok[:, None], s_new, s_prev)
    R, k = sel_ids.shape
    hitl = hit.long()
    nbr_s = torch.where((hitl >= 0)[..., None], s_upd[hitl.clamp(min=0)],
                        memory[sel_ids.long()])
    nbr_e = edge_feats[sel_eid.long()]
    kv = torch.cat([nbr_s, nbr_e], dim=-1)
    v = kv.reshape(R * k, -1) @ p["w_v"]
    v = v + lut_encode_plain(sel_dt.reshape(R * k), p["s_bounds"],
                             p["s_table"])
    v = (v + p["b_v"]).reshape(R, k, -1)
    agg = _softmax_fam_plain(sel_logits, sel_valid, v)
    h = torch.cat([s_upd, agg], dim=-1) @ p["w_out"] + p["b_out"]
    return h, s_upd


def fused_step(vids, sel_ids, sel_eid, hit, dt_mail, mail_ok, sel_dt,
               sel_logits, sel_valid, memory, mail, edge_feats,
               packed: dict):
    """The post-prune datapath of one batch: winner-row gather, kv
    projection, folded-LUT rows, masked softmax, FAM, output transform and
    the GRU memory update.

    ``vids`` (R,) int32; ``sel_ids``/``sel_eid``/``hit`` (R, k) int32 —
    ``hit[r, j] >= 0`` names the batch row whose updated memory is the
    committed memory of winner (r, j); ``dt_mail`` (R,) f32, ``mail_ok``
    (R,) bool; ``sel_dt``/``sel_logits`` (R, k) f32, ``sel_valid`` (R, k)
    bool; ``memory``/``mail``/``edge_feats`` the device tables, of which
    only the addressed rows are read. Returns ``(h (R, f_emb),
    s_upd (R, f_mem))``.
    """
    args = (vids, sel_ids, sel_eid, hit, dt_mail, mail_ok, sel_dt,
            sel_logits, sel_valid, memory, mail, edge_feats)
    if optrace.ACTIVE.recorder is not None:
        return optrace.ACTIVE.recorder.kernel(
            "fused_step", fused_step, args + (packed,), args + tuple(
                packed[n] for n in FUSED_READS))
    if vids.device.type == "cpu":
        return fused_step_plain(vids, sel_ids, sel_eid, hit, dt_mail,
                                mail_ok, sel_dt, sel_logits, sel_valid,
                                memory, mail, edge_feats, packed)
    p = packed
    R, k = sel_ids.shape
    V, M = memory.shape
    F = mail.shape[1]
    Fe = edge_feats.shape[1]
    E, D = p["s_table"].shape
    Femb = p["w_out"].shape[1]
    dev = vids.device
    if not 1 <= k <= MAX_K:
        raise ValueError(f"fused_step takes 1..{MAX_K} winners, got {k}")
    _check_cuda(dev, vids=(vids, I32), sel_ids=(sel_ids, I32),
                sel_eid=(sel_eid, I32), hit=(hit, I32),
                dt_mail=(dt_mail, F32), mail_ok=(mail_ok, BOOL),
                sel_dt=(sel_dt, F32), sel_logits=(sel_logits, F32),
                sel_valid=(sel_valid, BOOL), memory=(memory, F32),
                mail=(mail, F32), edge_feats=(edge_feats, F32),
                **{n: (p[n], F32) for n in FUSED_READS})
    _check_shape("vids", vids, (R,))
    for name, t in (("sel_eid", sel_eid), ("hit", hit), ("sel_dt", sel_dt),
                    ("sel_logits", sel_logits), ("sel_valid", sel_valid)):
        _check_shape(name, t, (R, k))
    _check_shape("dt_mail", dt_mail, (R,))
    _check_shape("mail_ok", mail_ok, (R,))
    _check_shape("mail", mail, (V, F))
    _check_shape("w_i", p["w_i"], (F, 3 * M))
    _check_shape("w_h", p["w_h"], (M, 3 * M))
    _check_gru_tc(p["w_tc"], F, M)
    _check_shape("b_i", p["b_i"], (3 * M,))
    _check_shape("b_h", p["b_h"], (3 * M,))
    _check_bounds("g_bounds", p["g_bounds"], E)
    _check_shape("g_table", p["g_table"], (E, 3 * M))
    _check_shape("w_v", p["w_v"], (M + Fe, D))
    _check_rows_tc("wv_tc", p["wv_tc"], (M, Fe), D, EU_DEPTH, EU_COLS)
    _check_shape("b_v", p["b_v"], (D,))
    _check_bounds("s_bounds", p["s_bounds"], E)
    _check_shape("w_out", p["w_out"], (M + D, Femb))
    _check_rows_tc("wout_tc", p["wout_tc"], (M, D), Femb, OUT_DEPTH,
                   OUT_COLS)
    _check_shape("b_out", p["b_out"], (Femb,))
    _check_table_rows("memory", memory)
    _check_table_rows("edge_feats", edge_feats)
    for per_block in (GRU_ROWS, eu_rows_per_block(k), OUT_ROWS):
        _check_grid_rows("fused_step", R, per_block)
    h = torch.empty((R, Femb), dtype=F32, device=dev)
    s_upd = torch.empty((R, M), dtype=F32, device=dev)
    agg = torch.empty((R, D), dtype=F32, device=dev)   # EU -> out scratch
    _launch("rt_fused_step", dev, vids, sel_ids, sel_eid, hit, dt_mail,
            mail_ok, sel_dt, sel_logits, sel_valid, memory, mail, edge_feats,
            p["w_tc"], p["b_i"], p["b_h"], p["g_bounds"],
            p["g_table"], p["wv_tc"], p["b_v"], p["s_bounds"], p["s_table"],
            p["wout_tc"], p["b_out"], h, s_upd, agg, R, k, M, F, Fe, D, Femb,
            E)
    LAUNCHES["fused_step"] += 1
    return h, s_upd
