"""The port's CUDA kernels on the card.

Every test here is marked ``cuda`` and skips where there is no CUDA device.
On a GPU machine run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The module imports neither JAX nor the reference package: it checks each
kernel against its plain PyTorch version on the same card (the plain
versions are held against the JAX kernels by tests/test_torch_kernels.py),
and the staged and fused engines on the card against the ref engine on the
CPU.

Tolerances: the LUT fetch copies table rows, so it must be exact. The
products are fp32 on both sides, summed in other orders: rtol = atol =
1e-5. Over a 10-step trajectory the GRU carries the rounding forward:
1e-4. A training step on the card against the CPU: the loss to rtol 1e-5,
each gradient leaf in the L2 norm to 1e-4 of its own norm plus 1e-6 of
the whole gradient's (leaves that are zero in exact arithmetic are
rounding noise; the card's backward scatters with atomics, so it is not
bitwise repeatable), and the next step's loss, after each side's own AdamW
update, to rtol 1e-4.
"""
import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.core import pipeline as pl
from repro_torch.core import tgn
from repro_torch.data import stream, temporal_graph as tgd
from repro_torch.kernels import ops
from repro_torch.serving.engine import EngineConfig, StreamingEngine
from repro_torch.training import optim
from repro_torch.training import tgn_trainer as trainer

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)
E = 128


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cases(dev, R, k, f_mem, f_edge, V, n_edges, seed=0):
    """Random inputs for all four kernels; dt values include every bucket
    boundary exactly, the float just below it, 0 and negatives."""
    rng = np.random.RandomState(seed)
    M, Fe, D = f_mem, f_edge, f_mem
    F = 2 * M + Fe

    def t(x):
        return torch.as_tensor(np.asarray(x), device=dev)

    def f32(*shape, scale=1.0):
        return t((rng.randn(*shape) * scale).astype(np.float32))

    inner = np.sort(10 ** rng.uniform(0, 7, E - 1)).astype(np.float32)
    special = np.concatenate([inner, np.nextafter(inner, -np.inf),
                              [0.0, -3.0]]).astype(np.float32)

    def dts(n):
        x = (10 ** rng.uniform(0, 7, n)).astype(np.float32)
        m = min(n, len(special))
        x[:m] = special[rng.permutation(len(special))[:m]]
        return x

    valid = rng.rand(R, k) > 0.3
    valid[0] = False                      # an all-invalid row
    c = dict(
        bounds=t(inner), dt=t(dts(R)), sel_dt=t(dts(R * k).reshape(R, k)),
        g_table=f32(E, 3 * M), s_table=f32(E, D),
        w_i=f32(F, 3 * M, scale=F ** -0.5), w_h=f32(M, 3 * M, scale=M ** -0.5),
        b_i=f32(3 * M), b_h=f32(3 * M), mail_rows=f32(R, F), s_rows=f32(R, M),
        extra=f32(R, 3 * M), w_v=f32(M + Fe, D, scale=(M + Fe) ** -0.5),
        b_v=f32(D), kv=f32(R, k, M + Fe), logits=f32(R, k, scale=3.0),
        valid=t(valid), w_out=f32(M + D, D, scale=(M + D) ** -0.5),
        b_out=f32(D), vids=t(rng.randint(0, V, R).astype(np.int32)),
        sel_ids=t(rng.randint(0, V, (R, k)).astype(np.int32)),
        sel_eid=t(rng.randint(0, n_edges, (R, k)).astype(np.int32)),
        hit=t(np.where(rng.rand(R, k) < 0.4, rng.randint(0, R, (R, k)),
                       -1).astype(np.int32)),
        mail_ok=t(rng.rand(R) > 0.3), memory=f32(V, M), mail=f32(V, F),
        edge_feats=f32(n_edges, Fe))
    return c


SHAPES = [  # R, k, f_mem, f_edge, V, n_edges
    (23, 4, 16, 24, 40, 60),
    (400, 4, 100, 172, 9227, 2000),      # the main path's widths
    (37, 10, 36, 0, 50, 10),             # k = m_r, no edge features
    (1, 2, 8, 5, 3, 4),
]
# and, for the GRU update's 16-row x 8-column tiles, row counts off the
# tile, f_mem off the column tile and f_mail = 2 f_mem + 5, not a multiple
# of 4 (rows not 16-byte aligned: the 4-byte copy path), over tables of
# n // 3 vertices (vids repeat)
GRU_SHAPES = SHAPES + [(n, 4, f_mem, 5, max(2, n // 3), 7)
                       for n in (1, 17, 401) for f_mem in (8, 36, 100)]
# and, for the EU's tiles of whole batch rows (16 // k of them an m16
# tile), k = 1, 6 (rows of padding in every tile) and 16 over batch rows
# off the tile, f_edge = 0 (no edge stages), and odd f_mem / f_edge (rows
# not 16-byte aligned: the 4-byte copy path); and the ladder's np2 and
# score-all (k = m_r = 10, one batch row a tile) rungs at R = 400 and
# paper width
EU_SHAPES = [
    (17, 1, 100, 172, 50, 60),
    (401, 6, 100, 172, 9227, 2000),
    (400, 2, 100, 172, 9227, 2000),
    (400, 10, 100, 172, 9227, 2000),
    (1, 16, 8, 5, 3, 4),
    (401, 16, 36, 0, 300, 10),
    (17, 6, 35, 7, 40, 30),
    (401, 1, 33, 0, 120, 9),
    (1, 6, 100, 172, 3, 4),
]


def _shifted(x):
    """A copy of x that starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    assert y.data_ptr() % 16 != 0
    return y


def _fused_pack(c):
    M, Fe = c["memory"].shape[1], c["edge_feats"].shape[1]
    F = c["mail"].shape[1]
    return ops.pack_fused_params(
        {n: c[n] for n in ("w_i", "w_h", "b_i", "b_h")},
        {n: c[n] for n in ("w_v", "b_v", "w_out", "b_out")},
        {"boundaries": c["bounds"], "table": c["g_table"]},
        {"boundaries": c["bounds"], "table": c["s_table"]}, F, M, Fe)


FUSED_ARGS = ("vids", "sel_ids", "sel_eid", "hit", "dt", "mail_ok", "sel_dt",
              "logits", "valid", "memory", "mail", "edge_feats")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_lut_encode_kernel_matches_plain(cuda_device, shape):
    c = _cases(cuda_device, *shape)
    p = ops.pack_lut_params(c["bounds"], c["g_table"])
    before = ops.LAUNCHES["lut_encode"]
    got = ops.lut_encode(c["dt"], p)
    want = ops.lut_encode_plain(c["dt"], p["bounds"], p["table"])
    torch.cuda.synchronize()
    assert ops.LAUNCHES["lut_encode"] == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GRU_SHAPES)
@pytest.mark.parametrize("with_extra", [True, False])
def test_gru_cell_kernel_matches_plain(cuda_device, shape, with_extra):
    c = _cases(cuda_device, *shape)
    extra = c["extra"] if with_extra else None
    p = ops.pack_gru_params(c["w_i"], c["w_h"], c["b_i"], c["b_h"])
    got = ops.gru_cell(c["mail_rows"], c["s_rows"], p, extra=extra)
    want = ops.gru_cell_plain(c["mail_rows"], c["s_rows"], c["w_i"],
                              c["w_h"], c["b_i"], c["b_h"], extra)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
def test_gru_cell_kernel_unaligned_rows_at_an_aligned_width(cuda_device):
    """F and M multiples of 4, but the tensors start 4 bytes past a
    16-byte boundary: the kernel must take the 4-byte copy path."""
    c = _cases(cuda_device, 45, 2, 100, 172, 3, 4)
    mail, s = _shifted(c["mail_rows"]), _shifted(c["s_rows"])
    p = ops.pack_gru_params(c["w_i"], c["w_h"], c["b_i"], c["b_h"])
    got = ops.gru_cell(mail, s, p, extra=c["extra"])
    want = ops.gru_cell_plain(c["mail_rows"], c["s_rows"], c["w_i"],
                              c["w_h"], c["b_i"], c["b_h"], c["extra"])
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + EU_SHAPES)
def test_sat_aggregate_kernel_matches_plain(cuda_device, shape):
    c = _cases(cuda_device, *shape)
    p = ops.pack_sat_params(c["w_v"], c["b_v"], c["bounds"], c["s_table"])
    args = (c["kv"], c["sel_dt"], c["logits"], c["valid"])
    before = ops.LAUNCHES["sat_aggregate"]
    got = ops.sat_aggregate(*args, p)
    want = ops.sat_aggregate_plain(*args, p["w_v"], p["b_v"], p["bounds"],
                                   p["table"])
    assert ops.LAUNCHES["sat_aggregate"] == before + 1
    torch.testing.assert_close(got, want, **TOL)
    assert not got[0].any()               # the all-invalid row gives zeros


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GRU_SHAPES + EU_SHAPES)
def test_fused_step_kernel_matches_plain(cuda_device, shape):
    c = _cases(cuda_device, *shape)
    p = _fused_pack(c)
    args = tuple(c[n] for n in FUSED_ARGS)
    assert (c["hit"] >= 0).any()          # winners read through s_upd
    before = ops.LAUNCHES["fused_step"]
    got_h, got_s = ops.fused_step(*args, p)
    want_h, want_s = ops.fused_step_plain(*args, p)
    assert ops.LAUNCHES["fused_step"] == before + 1
    torch.testing.assert_close(got_s, want_s, **TOL)
    torch.testing.assert_close(got_h, want_h, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["sat_aggregate", "fused_step"])
@pytest.mark.parametrize("k", [2, 10])
def test_eu_kernels_mask_invalid_slots_with_large_logits(cuda_device, kernel,
                                                        k):
    """Score-all selection (k = m_r) hands the kernels the raw logits of
    invalid slots: here they sit far above every valid logit, so an EU
    that did not mask by ``valid`` would weight them and fail."""
    c = _cases(cuda_device, 400, k, 100, 172, 9227, 2000, seed=k)
    c["logits"] = torch.where(c["valid"], c["logits"],
                              torch.full_like(c["logits"], 80.0))
    assert (~c["valid"][1:]).any() and c["valid"].any()
    if kernel == "sat_aggregate":
        p = ops.pack_sat_params(c["w_v"], c["b_v"], c["bounds"],
                                c["s_table"])
        args = (c["kv"], c["sel_dt"], c["logits"], c["valid"])
        got = ops.sat_aggregate(*args, p)
        want = ops.sat_aggregate_plain(*args, p["w_v"], p["b_v"],
                                       p["bounds"], p["table"])
        torch.testing.assert_close(got, want, **TOL)
        assert not got[0].any()           # the all-invalid row gives zeros
        return
    p = _fused_pack(c)
    args = tuple(c[n] for n in FUSED_ARGS)
    got_h, got_s = ops.fused_step(*args, p)
    want_h, want_s = ops.fused_step_plain(*args, p)
    torch.testing.assert_close(got_s, want_s, **TOL)
    torch.testing.assert_close(got_h, want_h, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["sat_aggregate", "fused_step"])
def test_eu_kernel_unaligned_rows_at_an_aligned_width(cuda_device, kernel):
    """f_mem and f_edge multiples of 4, but the row tables start 4 bytes
    past a 16-byte boundary: the EU must take the 4-byte copy path."""
    c = _cases(cuda_device, 45, 4, 100, 172, 30, 40)
    if kernel == "sat_aggregate":
        p = ops.pack_sat_params(c["w_v"], c["b_v"], c["bounds"],
                                c["s_table"])
        args = (c["kv"], c["sel_dt"], c["logits"], c["valid"])
        got = ops.sat_aggregate(_shifted(c["kv"]), *args[1:], p)
        want = ops.sat_aggregate_plain(*args, p["w_v"], p["b_v"],
                                       p["bounds"], p["table"])
        torch.testing.assert_close(got, want, **TOL)
        return
    p = _fused_pack(c)
    args = [c[n] for n in FUSED_ARGS]
    want_h, want_s = ops.fused_step_plain(*args, p)
    for n in ("memory", "edge_feats"):
        args[FUSED_ARGS.index(n)] = _shifted(c[n])
    got_h, got_s = ops.fused_step(*args, p)
    torch.testing.assert_close(got_s, want_s, **TOL)
    torch.testing.assert_close(got_h, want_h, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["staged", "fused"])
def test_engine_tier_on_card_matches_ref_on_cpu(cuda_device, tier):
    g = tgd.wikipedia_like(n_edges=300)
    dims = dict(n_nodes=g.cfg.n_nodes, n_edges=g.n_edges, f_edge=172,
                f_mem=16, f_time=16, f_emb=16, m_r=10)
    cfg = pl.variant_config("sat+lut+np4", **dims)
    params = pl.build_pipeline(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(3))
    engines = [StreamingEngine(EngineConfig(model=cfg, use_kernels=t),
                               params, g.edge_feats, device=d)
               for t, d in (("ref", "cpu"), (tier, cuda_device))]
    ops.reset_launch_counts()
    for batch in stream.fixed_count(g, 30):
        (rs, rd), (ks, kd) = (e.process(batch) for e in engines)
        torch.testing.assert_close(ks.cpu(), rs, **TRAJ_TOL)
        torch.testing.assert_close(kd.cpu(), rd, **TRAJ_TOL)
    counts = ops.launch_counts()
    names = (("fused_step",) if tier == "fused" else
             ("lut_encode", "gru_cell", "sat_aggregate"))
    assert all(counts[n] == 10 for n in names), counts
    ref, kern = (e.state for e in engines)
    for f in ref._fields:
        a, b = getattr(kern, f).cpu(), getattr(ref, f)
        if a.dtype.is_floating_point:
            torch.testing.assert_close(a, b, **TRAJ_TOL)
        else:
            assert torch.equal(a, b), f


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["staged", "fused"])
@pytest.mark.parametrize("variant", ["sat+lut", "sat+lut+np4+reservoir"])
def test_ladder_kernel_tier_matches_ref_on_card(cuda_device, variant, tier):
    """Score-all (k = 10) and the reservoir sampler at paper width: the
    kernel tier and the ref tier, both on the card, over 10 batches; the
    tiers share the selection code, so their selections are equal."""
    g = tgd.wikipedia_like(n_edges=600)
    dims = dict(n_nodes=g.cfg.n_nodes, n_edges=g.n_edges, f_edge=172,
                f_mem=100, f_time=100, f_emb=100, m_r=10)
    cfg = pl.variant_config(variant, **dims)
    params = pl.build_pipeline(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(4))
    engines = [StreamingEngine(EngineConfig(model=cfg, use_kernels=t),
                               params, g.edge_feats, device=cuda_device)
               for t in ("ref", tier)]
    assert engines[1].describe()["tier"] == tier
    ops.reset_launch_counts()
    for batch in stream.fixed_count(g, 60):
        (rs, rd), (ks, kd) = (e.process(batch) for e in engines)
        m = torch.as_tensor(batch.valid, device=cuda_device)
        torch.testing.assert_close(ks[m], rs[m], **TRAJ_TOL)
        torch.testing.assert_close(kd[m], rd[m], **TRAJ_TOL)
    counts = ops.launch_counts()
    names = (("fused_step",) if tier == "fused" else
             ("lut_encode", "gru_cell", "sat_aggregate"))
    assert all(counts[n] == (10 if n in names else 0) for n in counts), \
        counts
    ref, kern = (e.state for e in engines)
    for f in ref._fields:
        a, b = getattr(kern, f), getattr(ref, f)
        if a.dtype.is_floating_point:
            torch.testing.assert_close(a, b, **TRAJ_TOL)
        else:
            assert torch.equal(a, b), f


# lut_encode at the main path's shapes and off them: row counts off the
# 4-row block (0, 1, 401), D = 301 (4-byte copies), D = 48 (one pass of
# 16-byte copies over half a warp), E = 16 (bounds of 15 boundaries and
# one sentinel)
LUT_CASES = [(n, D, e) for n in (0, 1, 400, 401) for D in (300, 301, 48)
             for e in (16, 128)]


def _lut_case(dev, n, D, e, seed):
    """Sorted boundaries, a table, and dt values that include every
    boundary exactly, the float just below it, NaN, +-inf, 0, negatives
    and values below the first boundary."""
    rng = np.random.RandomState(seed)
    inner = np.sort(10 ** rng.uniform(0, 7, e - 1)).astype(np.float32)
    special = np.concatenate([
        inner, np.nextafter(inner, -np.inf),
        [np.nan, np.inf, -np.inf, 0.0, -3.0, inner[0] / 2]]).astype(
            np.float32)
    dt = (10 ** rng.uniform(-1, 7.5, n)).astype(np.float32)
    m = min(n, len(special))
    dt[:m] = special[rng.permutation(len(special))[:m]]
    table = rng.randn(e, D).astype(np.float32)
    return tuple(torch.as_tensor(x, device=dev) for x in (dt, inner, table))


@pytest.mark.cuda
@pytest.mark.parametrize("n,D,e", LUT_CASES)
def test_lut_encode_kernel_at_odd_shapes_and_special_dt(cuda_device, n, D, e):
    dt, inner, table = _lut_case(cuda_device, n, D, e, seed=n + D + e)
    p = ops.pack_lut_params(inner, table)
    assert p["bounds"].shape == (ops.n_bounds(e),)
    before = ops.LAUNCHES["lut_encode"]
    got = ops.lut_encode(dt, p)
    want = ops.lut_encode_plain(dt, p["bounds"], p["table"])
    torch.cuda.synchronize()
    assert ops.LAUNCHES["lut_encode"] == before + (n > 0)
    assert got.shape == (n, D)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [300, 48])
def test_lut_encode_kernel_table_off_a_16_byte_boundary(cuda_device, D):
    """D a multiple of 4, but the table starts 4 bytes past a 16-byte
    boundary: the kernel must take its 4-byte copies."""
    dt, inner, table = _lut_case(cuda_device, 401, D, 128, seed=D)
    p = ops.pack_lut_params(inner, table)
    shifted = {"bounds": p["bounds"], "table": _shifted(p["table"])}
    got = ops.lut_encode(dt, shifted)
    want = ops.lut_encode_plain(dt, p["bounds"], p["table"])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["sat_aggregate", "fused_step"])
@pytest.mark.parametrize("e", [13, 128])
def test_eu_buckets_match_lut_encode_plain(cuda_device, kernel, e):
    """The EU kernels' buckets are lut_encode_plain's, at the special dt
    values above: W_v and b_v are 0 and one winner a row is valid, so the
    aggregate of a row is exactly the folded-LUT row of its winner's
    bucket; fused_step's h is that row through an identity W_out, and its
    s_upd reads the GRU-folded rows of dt_mail's buckets. Table rows are
    far apart (1.0), so a wrong bucket cannot hide in the tolerance."""
    R, k, M = 401, 4, 100
    c = _cases(cuda_device, R, k, M, 172, 300, 500, seed=e)
    dt, inner, _ = _lut_case(cuda_device, R * k + R, 1, e, seed=e + 1)
    sel_dt, dt_mail = dt[:R * k].reshape(R, k).contiguous(), dt[R * k:]
    rows = torch.arange(e, dtype=torch.float32, device=cuda_device)
    s_table = rows[:, None] + 1e-3 * torch.randn(e, M, device=cuda_device)
    valid = torch.zeros((R, k), dtype=torch.bool, device=cuda_device)
    valid[:, 1] = True
    c.update(bounds=inner, s_table=s_table, valid=valid, sel_dt=sel_dt,
             dt=dt_mail, w_v=torch.zeros_like(c["w_v"]),
             b_v=torch.zeros_like(c["b_v"]),
             g_table=0.1 * (rows[:, None] - e / 2).expand(e, 3 * M)
             .contiguous())
    want_agg = ops.lut_encode_plain(
        sel_dt[:, 1].contiguous(), ops.sentinel_bounds(inner, e), s_table)
    if kernel == "sat_aggregate":
        p = ops.pack_sat_params(c["w_v"], c["b_v"], inner, s_table)
        got = ops.sat_aggregate(c["kv"], sel_dt, c["logits"], valid, p)
        torch.testing.assert_close(got, want_agg, rtol=0, atol=0)
        return
    c.update(w_out=torch.cat([torch.zeros(M, M, device=cuda_device),
                              torch.eye(M, device=cuda_device)]),
             b_out=torch.zeros_like(c["b_out"]))
    p = _fused_pack(c)
    args = tuple(c[n] for n in FUSED_ARGS)
    got_h, got_s = ops.fused_step(*args, p)
    want_h, want_s = ops.fused_step_plain(*args, p)
    torch.testing.assert_close(got_h, want_agg, **TOL)
    torch.testing.assert_close(got_s, want_s, **TOL)
    torch.testing.assert_close(want_h, want_agg, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["sat_aggregate", "gru_cell"])
def test_kernels_at_gdelt_widths(cuda_device, kernel):
    """The GDELT-like path's shapes: no edge features, so the EU's kv rows
    are the memory rows alone (K = 100) and the GRU's mail is 200 wide."""
    c = _cases(cuda_device, 400, 4, 100, 0, 1000, 2000)
    assert c["edge_feats"].shape == (2000, 0)
    if kernel == "gru_cell":
        assert c["mail_rows"].shape == (400, 200)
        p = ops.pack_gru_params(c["w_i"], c["w_h"], c["b_i"], c["b_h"])
        got = ops.gru_cell(c["mail_rows"], c["s_rows"], p, extra=c["extra"])
        want = ops.gru_cell_plain(c["mail_rows"], c["s_rows"], c["w_i"],
                                  c["w_h"], c["b_i"], c["b_h"], c["extra"])
    else:
        assert c["kv"].shape == (400, 4, 100)
        p = ops.pack_sat_params(c["w_v"], c["b_v"], c["bounds"],
                                c["s_table"])
        args = (c["kv"], c["sel_dt"], c["logits"], c["valid"])
        got = ops.sat_aggregate(*args, p)
        want = ops.sat_aggregate_plain(*args, p["w_v"], p["b_v"],
                                       p["bounds"], p["table"])
    torch.testing.assert_close(got, want, **TOL)


# ---------------------------------------------------------------------------
# training steps on the card against the CPU
# ---------------------------------------------------------------------------


def _train_setup(variant, dev, dims, g, teacher_params):
    """Weights, a state three batches in, and the loss and step functions
    of a teacher step (``variant`` "teacher") or a distill step, on
    ``dev``."""
    cfg = pl.variant_config(variant, **dims)
    t_cfg = pl.variant_config("teacher", **dims)
    tcfg = trainer.TGNTrainConfig(batch_size=50)
    nf, ef = trainer.features(g, cfg, dev)
    ocfg = optim.OptimConfig(name="adamw", lr=1e-3, weight_decay=0.0)
    tp = tree.map(lambda x: x.to(dev), teacher_params)
    batches = [trainer.batch_tensors(b, dev)
               for b in stream.fixed_count(g, 50, window=slice(0, 250))]
    if variant == "teacher":
        params, lead, cfgs = tp, (), (cfg,)
        loss_fn = trainer.make_teacher_loss(cfg, nf, ef)
        step = trainer.make_teacher_step(cfg, ocfg, nf, ef)
    else:
        params = tgn.init_params(torch.Generator().manual_seed(7), cfg, dev,
                                 dt_samples=trainer._dt_samples(
                                     g, slice(0, 250)))
        lead, cfgs = (tp,), (cfg, t_cfg)
        loss_fn = trainer.make_distill_loss(cfg, t_cfg, tcfg, nf, ef)
        step = trainer.make_distill_step(cfg, t_cfg, ocfg, tcfg, nf, ef)
    states = [tgn.init_state(c, dev) for c in cfgs]
    with torch.no_grad():
        for b in batches[:3]:
            states = [pl.build_pipeline(c, device=dev).step_fn(
                p, st, b[:5], ef).state
                for c, p, st in zip(cfgs, (params,) + lead, states)]
    return params, lead, states, batches[3:], loss_fn, step, ocfg


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["teacher", "sat+lut+np4"])
def test_training_step_on_card_matches_cpu(cuda_device, variant):
    g = tgd.wikipedia_like(n_edges=600)
    dims = dict(n_nodes=g.cfg.n_nodes, n_edges=g.n_edges, f_edge=172,
                f_mem=100, f_time=100, f_emb=100, m_r=10)
    teacher = tgn.init_params(torch.Generator().manual_seed(5),
                              pl.variant_config("teacher", **dims), "cpu")
    out = {}
    for dev in ("cpu", cuda_device):
        params, lead, states, (b1, b2), loss_fn, step, ocfg = _train_setup(
            variant, dev, dims, g, teacher)
        loss, _, grads = trainer.value_and_grad(loss_fn, params, *lead,
                                                *states, b1)
        res = step(params, *lead, optim.init_state(ocfg, params), *states,
                   b1)
        params, opt_state, states = res[0], res[1], res[2:-1]
        loss2, _, _ = trainer.value_and_grad(loss_fn, params, *lead,
                                             *states, b2)
        out[str(dev)] = (float(loss), float(loss2),
                         tree.map(lambda x: x.cpu(), grads))
    (l1, l2, want), (m1, m2, got) = out["cpu"], out[str(cuda_device)]
    np.testing.assert_allclose(m1, l1, rtol=1e-5)
    np.testing.assert_allclose(m2, l2, rtol=1e-4)
    total = float(torch.sqrt(sum((w ** 2).sum() for w in tree.leaves(want))))
    for path, a, b in zip(tree.leaf_paths(got), tree.leaves(got),
                          tree.leaves(want)):
        assert torch.isfinite(a).all(), path
        d = float(torch.linalg.vector_norm(a - b))
        assert d <= 1e-4 * float(torch.linalg.vector_norm(b)) + \
            1e-6 * total, (path, d)
