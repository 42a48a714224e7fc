"""The yardstick's arithmetic: the card's peaks, the model's MACs per
dynamic embedding, and the operations and bytes of the kernels whose
roofline share the benchmark reports. Frozen here so that a change to the
program cannot move it.

Peaks: one NVIDIA H100 SXM (data sheet): 67 TFLOP/s fp32 outside the
tensor cores, 989 TFLOP/s TF32 on them with sparsity (494.5 dense), 3.35
TB/s of HBM3. A matrix product at fp32's accuracy is fastest as 3xTF32,
three dense TF32 products (the port's kernels run theirs so), so products
are held to a third of the dense TF32 rate and every other operation to
the fp32 rate. A kernel's least time is the longest of its products over
their peak, its other operations over theirs, and its bytes over the
bandwidth.
"""
from __future__ import annotations

PEAK_FLOPS = 67e12
PEAK_PRODUCTS = 989e12 / 2 / 3
PEAK_BYTES = 3.35e12
F32 = 4


def bound_s(nbytes: float, flops: float, products: float = 0.0) -> float:
    """Least time of ``nbytes`` moved, ``products`` operations of matrix
    products and ``flops`` other operations."""
    return max(nbytes / PEAK_BYTES, products / PEAK_PRODUCTS,
               flops / PEAK_FLOPS)


def stage_macs(cfg: dict) -> int:
    """MACs per dynamic node embedding (a copy of
    ``repro_torch.core.complexity.stage_macs``'s total): one MAC per
    weight of a dense layer applied to one vector; the time encoding's
    omega * dt counts, the LUT's row fetch does not."""
    m, t, e, d = cfg["f_mem"], cfg["f_time"], cfg["f_edge"], cfg["f_emb"]
    m_r = cfg["m_r"]
    k = cfg["prune_k"] if cfg["prune_k"] is not None else m_r
    mail = 2 * m + e + t
    if cfg["encoder"] == "cosine":
        memory = t + 3 * mail * m + 3 * m * m
    else:
        memory = 3 * (mail - t) * m + 3 * m * m
    out = (m + d) * d
    if cfg["attention"] == "vanilla":
        te = t * (1 + m_r) if cfg["encoder"] == "cosine" else 0
        gnn = (te + (m + t) * d + 2 * m_r * (m + e + t) * d + 2 * m_r * d
               + out)
    else:
        te = t * k if cfg["encoder"] == "cosine" else 0
        width = m + e + (t if cfg["encoder"] == "cosine" else 0)
        gnn = m_r * m_r + te + k * width * d + k * d + out
    return memory + gnn


def fused_step(cfg: dict, rows: int) -> tuple[int, int, int]:
    """(bytes, other operations, product operations) of one
    ``fused_step`` call over ``rows`` vertex
    instances: phase 0, the GRU over each row's mail and memory with its
    folded LUT row; phase 1, the k winners' values with their LUT rows,
    the softmax-weighted sum and the output transform. Bytes count each
    input once and each output once: per row its ids, dt, mail flag, mail
    and memory rows, its k winners' ids, edge ids, redirects, dt, scores,
    flags, memory rows and edge-feature rows (the rows prune-then-fetch
    reads, never the whole tables), the weights and LUT tables, and the
    updated memory and embedding written. Operations as ``chip_smoke``
    counts them (their sum is its count), the products being the GRU's
    two projections, the values' and the output transform."""
    R, M, Fe, D = rows, cfg["f_mem"], cfg["f_edge"], cfg["f_emb"]
    K, E = cfg["prune_k"], cfg["lut_entries"]
    F = 2 * M + Fe
    products = (2 * R * (F + M) * 3 * M + 2 * R * K * (M + Fe) * D
                + 2 * R * (M + D) * D)
    other = 12 * R * M + R * E + R * K * E + 4 * R * K * D
    weights = ((F + M) * 3 * M + 2 * 3 * M + E * 3 * M
               + (M + Fe) * D + D + E * D + (M + D) * D + D + 2 * E)
    per_row = (4 + 4 + 1 + (F + M) * F32
               + K * (4 + 4 + 4 + 4 + 4 + 1) + K * (M + Fe) * F32
               + (M + D) * F32)
    return R * per_row + weights * F32, other, products


def products(cfg: dict, rows: int) -> list:
    """``[(count, m, k, n), ...]``: the products of the teacher's step over
    ``rows`` vertex instances of one tenant: the GRU's input and hidden
    projections, the query, the keys and values over every ring slot and
    the output transform (one each); then per row and head its scores
    (1 x d_head by d_head x m_r) and its weighted sum (1 x m_r by m_r x
    d_head)."""
    m, t, e, d = cfg["f_mem"], cfg["f_time"], cfg["f_edge"], cfg["f_emb"]
    m_r, H = cfg["m_r"], cfg["n_heads"]
    mail, kv = 2 * m + e + t, m + e + t
    return [(1, rows, mail, 3 * m), (1, rows, m, 3 * m), (1, rows, m + t, d),
            (1, rows * m_r, kv, d), (1, rows * m_r, kv, d),
            (1, rows, m + d, d),
            (rows * H, 1, d // H, m_r), (rows * H, 1, m_r, d // H)]


def products_bound_s(cfg: dict, rows: int, tenants: int) -> float:
    """Least time of the teacher's products a round: each product's
    operations (2 m k n) and bytes (both operands once, the result once)
    bound on its own, summed over the products and the tenants (each
    tenant's products run on their own)."""
    total = 0.0
    for c, mm, kk, nn in products(cfg, rows):
        total += c * bound_s(F32 * (mm * kk + kk * nn + mm * nn), 0,
                             2 * mm * kk * nn)
    return total * tenants
