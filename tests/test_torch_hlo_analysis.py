"""The port's op-trace analyzer (``repro_torch/launch/hlo_analysis.py``).

The reference's analyzer cases (``tests/test_sharding.py``): a 5-trip
loop's product FLOPs, exactly, beside the reference's count of the same
scan; no collective on one device; each collective kind's bytes at the
reference's factor (``COLLECTIVE_FACTORS``) on a (2, 2) mesh over a fake
process group; a DTensor product counted at its local shape. Then the
folds: at smoke width, every fold site's forward cells folded equal their
unrolled traces exactly, a training step's FLOPs and bytes within 1%, and
without a recorder the hooks change nothing (a model's loss and gradients
bitwise those of the same model traced unfolded). Last the TGN step's
traffic: the kernels are opaque entries, 3 on the staged tier and 1 on the
fused, and a step's trace is the same run after run; the same batch
through the reference's pipeline and ``jaxpr_traffic`` gives as many
``pallas_call`` launches, and its bytes differ from the port's only where
a difference is named with its cause; a kernel called from another thread
while a record runs is not recorded.

The fake process group is destroyed after each test that makes one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import hlo_analysis as jH

from repro_torch import configs, tree
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import main_path as mp
from repro_torch.models import lm_common
from repro_torch.obs import optrace

torch.set_num_threads(1)

META = torch.device("meta")
#: a training step folded against unrolled, FLOPs and bytes (relative)
TRAIN_FOLD_RTOL = 0.01


@pytest.fixture
def world():
    yield
    dryrun.destroy_world()


def _mesh22():
    from repro_torch.distributed.tgn_sharding import TenantMesh
    return dryrun.device_mesh(TenantMesh(
        np.asarray([[META] * 2] * 2, dtype=object), ("data", "model")),
        "cpu")


def _loop(x, ws):
    for i in optrace.trips("loop", ws.shape[0]):
        x = torch.tanh(x @ ws[i])
    return x


@pytest.mark.parametrize("fold", [True, False])
def test_trip_count_loop_gives_exact_product_flops(fold):
    x = torch.empty(32, 64, device=META)
    ws = torch.empty(5, 64, 64, device=META)
    trace = H.record(_loop, x, ws, fold=fold)
    stats = H.analyze(trace)
    want_dot = 5 * 2 * 32 * 64 * 64
    assert sum(stats["flops_by_dtype"].values()) == want_dot
    assert stats["flops_by_dtype"] == {"f32": want_dot}
    assert stats["flops"] == want_dot + 5 * 32 * 64          # + the tanh
    assert stats["transcendentals"] == 5 * 32 * 64
    assert trace["folds"] == ({"loop": 5} if fold else {})
    # the reference's analyzer on the same scan: within its 2%
    def scanned(x, ws):
        def step(c, w):
            return jnp.tanh(c @ w), None
        return jax.lax.scan(step, x, ws)[0]
    compiled = jax.jit(scanned).lower(
        jax.ShapeDtypeStruct((32, 64), jnp.float32),
        jax.ShapeDtypeStruct((5, 64, 64), jnp.float32)).compile()
    ref = jH.analyze(compiled.as_text())["flops"]
    assert abs(ref - want_dot) / want_dot < 0.02


def test_single_device_no_collectives():
    x = torch.empty(64, 64, device=META)
    stats = H.analyze(H.record(lambda x: x @ x.T, x))
    assert stats["collective_bytes"] == 0.0
    assert stats["collectives_by_op"] == {}


@pytest.mark.parametrize("kind", ["all_gather_into_tensor", "all_reduce",
                                  "reduce_scatter_tensor",
                                  "all_to_all_single"])
def test_collective_factor(kind, world):
    """One collective of each kind on a (2, 2) mesh's ``model`` group: its
    per-device bytes are the reference's factor times the side it names
    (an all-gather its result, an all-reduce twice its operand, ...)."""
    import torch.distributed._functional_collectives as fc
    group = _mesh22().get_group("model")
    x = torch.empty(8, 16, device=META)
    calls = {
        "all_gather_into_tensor": lambda t: fc.all_gather_tensor(t, 0, group),
        "all_reduce": lambda t: fc.all_reduce(t, "sum", group),
        "reduce_scatter_tensor": lambda t: fc.reduce_scatter_tensor(
            t, "sum", 0, group),
        "all_to_all_single": lambda t: fc.all_to_all_single(
            t, None, None, group),
    }
    stats = H.analyze(H.record(lambda t: fc.wait_tensor(calls[kind](t)), x))
    side, factor = H.COLLECTIVE_FACTORS[kind]
    raw = 8 * 16 * 4 * (2 if side == "result" else 1)   # 2 in the group
    assert stats["collectives_by_op"] == {kind: raw}
    assert stats["collectives_count"] == {kind: 1}
    assert stats["collective_bytes"] == factor * raw


def test_dtensor_product_counts_its_local_shape(world):
    """(16, 64) @ (64, 32), the rows sharded over ``data`` and the columns
    over ``model``: each device multiplies (8, 64) @ (64, 16), 16,384 FLOPs
    (``FlopCounterMode`` above DTensor counts the global 65,536, and so
    does the record's ``flop_counter``)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    mesh = _mesh22()
    a = DTensor.from_local(torch.empty(8, 64, device=META), mesh,
                           [Shard(0), Replicate()], run_check=False,
                           shape=(16, 64), stride=(64, 1))
    b = DTensor.from_local(torch.empty(64, 16, device=META), mesh,
                           [Replicate(), Shard(1)], run_check=False,
                           shape=(64, 32), stride=(32, 1))
    trace = H.record(lambda a, b: a @ b, a, b)
    stats = H.analyze(trace)
    assert stats["flops_by_dtype"] == {"f32": 16_384}
    assert stats["collective_bytes"] == 0.0
    counter = FlopCounterMode(display=False)
    with counter:
        a @ b
    assert counter.get_total_flops() == trace["flop_counter"] == 65_536


# ---------------------------------------------------------------------------
# folds
# ---------------------------------------------------------------------------

#: every fold site, each at 4+ trips: blocks and attention's query and key
#: blocks (qwen3), layers and SSD chunks (mamba2), blocks, the windowed
#: attention's query blocks and the RG-LRU's time steps (recurrentgemma),
#: encoder and decoder layers (whisper)
FOLD_ARCHS = ("qwen3_8b", "mamba2_130m", "recurrentgemma_9b", "whisper_tiny")
B, S = 2, 64


def _cfg(arch):
    cfg = configs.get(arch).smoke_config()
    per_block = len(cfg.pattern) if hasattr(cfg, "pattern") else 1
    return cfg.replace(n_layers=4 * per_block)


def _model(arch):
    cfg = _cfg(arch)
    params = lm_common.init_params(torch.Generator().manual_seed(0), cfg,
                                   "cpu")
    return cfg, params, lm_common.train_inputs(cfg, B, S, abstract=False,
                                              device="cpu")


def _loss_and_grads(cfg, params, batch):
    live = [x.detach().requires_grad_() for x in tree.leaves(params)]
    loss = lm_common.loss_fn(tree.unflatten(params, live), cfg, batch)
    return loss, torch.autograd.grad(loss, live, allow_unused=True)


def _sites(trace):
    return set(trace["folds"])


@pytest.mark.parametrize("arch", FOLD_ARCHS)
def test_folded_forward_cells_equal_unrolled(arch):
    """The loss's forward and one decode step against a cache: folded and
    unrolled traces give the same FLOPs, bytes and collectives exactly."""
    cfg, params, batch = _model(arch)

    def forward(p, b):
        with torch.no_grad():
            return lm_common.loss_fn(p, cfg, b)

    def decode(p, d):
        with torch.no_grad():
            return lm_common.decode_fn(p, cfg, d)[0]

    def dec():      # a fresh cache each run: decode writes it in place
        return lm_common.decode_inputs(cfg, B, S, abstract=False,
                                       device="cpu")

    for fn, args in ((forward, lambda: (params, batch)),
                     (decode, lambda: (params, dec()))):
        folded = H.record(fn, *args())
        unrolled = H.record(fn, *args(), fold=False)
        assert folded["folds"] and not unrolled["folds"]
        a, b = H.analyze(folded), H.analyze(unrolled)
        for key in ("flops", "bytes", "transcendentals", "collective_bytes",
                    "flops_by_dtype", "bytes_by_kind"):
            assert a[key] == b[key], key
        assert len(folded["ops"]) < len(unrolled["ops"])


@pytest.mark.parametrize("arch", FOLD_ARCHS)
def test_folded_training_step_within_1_percent(arch):
    cfg, params, batch = _model(arch)
    folded = H.record(lambda p, b: _loss_and_grads(cfg, p, b), params, batch)
    unrolled = H.record(lambda p, b: _loss_and_grads(cfg, p, b), params,
                        batch, fold=False)
    a, b = H.analyze(folded), H.analyze(unrolled)
    for key in ("flops", "bytes"):
        assert abs(a[key] - b[key]) <= TRAIN_FOLD_RTOL * b[key], (
            key, a[key], b[key])
    assert sum(a["flops_by_dtype"].values()) == pytest.approx(
        sum(b["flops_by_dtype"].values()), rel=TRAIN_FOLD_RTOL)


def test_every_fold_site_is_exercised():
    seen = set()
    for arch in FOLD_ARCHS:
        cfg, params, batch = _model(arch)
        with torch.no_grad():
            seen |= _sites(H.record(
                lambda p, b: lm_common.loss_fn(p, cfg, b), params, batch))
    assert seen == {"blocks", "attn_q", "attn_k", "layers", "ssd_chunk",
                    "rglru_time", "enc_layers", "dec_layers"}


@pytest.mark.parametrize("arch", ("qwen3_8b", "mamba2_130m",
                                  "recurrentgemma_9b"))
def test_without_a_recorder_the_models_are_unchanged(arch):
    """The hooks are the identity without a recorder, and a model's loss
    and gradients are bitwise those of the same model run under the
    recorder unfolded (every op executed as written)."""
    assert optrace.ACTIVE.recorder is None
    assert optrace.trips("x", 5) == range(5)
    items = [1, 2]
    assert optrace.fill(items, 7) is items
    f = object()
    assert optrace.pinned(f) is f
    cfg, params, batch = _model(arch)
    loss, grads = _loss_and_grads(cfg, params, batch)
    got = {}

    def traced(p, b):
        got["out"] = _loss_and_grads(cfg, p, b)
        return got["out"][0]

    H.record(traced, params, batch, fold=False)
    assert torch.equal(loss, got["out"][0])
    for g, w in zip(grads, got["out"][1]):
        assert (g is None and w is None) or torch.equal(g, w)


# ---------------------------------------------------------------------------
# the TGN step's traffic
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tgn_path():
    from repro_torch.data import temporal_graph as tgd
    g = tgd.generate(tgd.StreamConfig(n_users=300, n_items=100,
                                      n_edges=2000, f_edge=172, f_feat=0,
                                      seed=0))
    cfg, params = mp.model(g, mp.STUDENT, "cpu")
    return g, cfg, params


@pytest.mark.parametrize("tier,want", [
    ("staged", {"lut_encode": 1, "gru_cell": 1, "sat_aggregate": 1}),
    ("fused", {"fused_step": 1}), ("ref", {})])
def test_step_traffic_counts_each_kernel_once(tgn_path, tier, want):
    """3 launches a staged step, 1 a fused one (the reference's counts,
    ``tests/test_kernels.py``), none on ref; the CPU's plain versions run
    inside the opaque entries and are not recorded; two traces of the step
    are equal."""
    g, cfg, params = tgn_path
    first = mp.step_traffic(g, cfg, params, tier, "cpu")
    again = mp.step_traffic(g, cfg, params, tier, "cpu")
    assert first["kernel_launches"] == want
    assert first["accounting"] == "dispatch"
    assert first["bytes"] == again["bytes"] > 0
    assert first["bytes_by_kind"] == again["bytes_by_kind"]
    kinds = set(first["bytes_by_kind"])
    assert {k for k in kinds if k.startswith("kernel.")} == {
        f"kernel.{n}" for n in want}
    if tier == "fused":     # the fused step's products are all inside it
        assert "mm" not in kinds and "addmm" not in kinds


# ---------------------------------------------------------------------------
# the TGN step's traffic against the reference's jaxpr traffic
# ---------------------------------------------------------------------------

#: the reference's primitives the port's trace has no counterpart for:
#: views and layout moves (free in the port, as in the reference's own HLO
#: accounting, ``_NO_BYTES``), broadcasts (torch broadcasts without
#: materializing), the kernels' block padding, dtype converts
REF_LAYOUT = {"reshape", "slice", "squeeze", "expand_dims", "transpose",
              "pad", "copy", "copy_p", "broadcast_in_dim", "iota",
              "convert_element_type"}
#: the port's fills, casts and copies and its update ops (the reference's
#: jaxpr accounting charges a scatter 2 x ``eqn.invars[1]``, its indices;
#: the port, as the reference's HLO accounting, 2 x the updates)
PORT_OWN = {"full_like", "zeros_like", "ones_like", "full", "scalar_tensor",
            "arange", "new_zeros", "zeros", "ones", "_to_copy", "clone",
            "index_put", "index_add"}
REF_UPDATE = {"scatter", "scatter-add", "scatter_add"}
#: port / reference on the (2B, 2B) last-write-wins pair matrix: the
#: port's race runs on int64 positions (torch's ``arange``) with its -1
#: fill materialized, the reference's on int32 with a scalar -1, so the
#: where and the max move twice the bytes
PAIR_RATIO = 1.5234
#: port / reference kernel operands and results: the reference pads each
#: kernel's rows to 512 and widths to lane multiples (staged); the port's
#: fused step reads copies of the memory and mail tables (its step clones
#: the state before committing in place), which the reference's jaxpr
#: reads from the step's inputs
KERNEL_RATIO = {"staged": 0.6002, "fused": 1.9226}
NAMED_RTOL = 0.02
#: everything else (products, elementwise, gathers, concatenations,
#: reductions): within this of the reference's
REST_RTOL = 0.12


def _ref_classes(closed, R: int) -> dict:
    """The reference's ``jaxpr_traffic`` (intermediates only) of a closed
    jaxpr, split into the classes above; its own conventions and tables."""
    out = {"kernel": 0.0, "layout": 0.0, "update": 0.0, "pair": 0.0,
           "rest": 0.0, "launches": 0}

    def visit(jaxpr, params_set, mult):
        for eqn in jaxpr.eqns:
            name = eqn.primitive.name
            sub = jH._JAXPR_CALLS.get(name)
            if sub is not None and sub in eqn.params:
                inner = eqn.params[sub]
                inner = getattr(inner, "jaxpr", inner)
                visit(inner, {iv for iv, ov in zip(inner.invars, eqn.invars)
                              if not jH._is_var(ov) or ov in params_set},
                      mult)
                continue
            if name == "scan":
                visit(eqn.params["jaxpr"].jaxpr, set(),
                      mult * eqn.params["length"])
                continue
            if name == "while":
                visit(eqn.params["body_jaxpr"].jaxpr, set(), mult)
                continue
            out_b = sum(jH._aval_bytes(v) for v in eqn.outvars)
            if name in jH._JAXPR_REGION:
                b = 2 * out_b
            elif name in jH._JAXPR_REGION_UPDATE:
                b = 2 * jH._aval_bytes(eqn.invars[1] if len(eqn.invars) > 1
                                       else eqn.invars[-1])
            else:
                b = out_b + sum(jH._aval_bytes(v) for v in eqn.invars
                                if jH._is_var(v) and v not in params_set)
            shapes = [tuple(v.aval.shape) for v in (*eqn.invars,
                                                    *eqn.outvars)
                      if hasattr(v, "aval")]
            if name == "pallas_call":
                out["launches"] += int(mult)
                cls = "kernel"
            elif name in REF_LAYOUT:
                cls = "layout"
            elif name in REF_UPDATE:
                cls = "update"
            elif any(s[-2:] == (R, R) for s in shapes):
                cls = "pair"
            else:
                cls = "rest"
            out[cls] += mult * b

    visit(closed.jaxpr,
          set(closed.jaxpr.invars) | set(closed.jaxpr.constvars), 1.0)
    return out


def _port_classes(trace, R: int) -> dict:
    out = {"kernel": 0.0, "own": 0.0, "pair": 0.0, "rest": 0.0}
    for e in trace["ops"]:
        base = H._entry_base(e)
        b = e["m"] * H._op_bytes(base, e, True)
        if "kernel" in e:
            cls = "kernel"
        elif base in PORT_OWN:
            cls = "own"
        elif any(d[0][-2:] == [R, R] for d in e["in"] + e["out"]):
            cls = "pair"
        else:
            cls = "rest"
        out[cls] += b
    return out


@pytest.mark.parametrize("tier", ("staged", "fused", "ref"))
def test_step_traffic_against_the_reference(tgn_path, tier, monkeypatch):
    """The same Wikipedia-path batch through the reference's pipeline
    (parameters converted from the port's) and its ``jaxpr_traffic``: its
    ``pallas_launches`` equal the port's ``kernel_launches`` (3, 1, 0);
    its bytes, split into classes, against the port's: each difference
    named above with its cause, what is left within ``REST_RTOL``.

    The reference's ``jaxpr_traffic`` predates the JAX it runs on here:
    ``jax.core.Var`` moved to ``jax.extend.core`` and ``pjit`` is named
    ``jit``; both are patched for the test, in memory (without the second
    it counts no kernel and charges every jitted call whole)."""
    import jax.extend
    from repro.core import pipeline as jpl
    from repro.core import tgn as jtgn
    from repro_torch import convert
    from repro_torch.core import pipeline as pl
    from repro_torch.data import stream

    monkeypatch.setattr(jH, "_is_var", lambda v: isinstance(
        v, jax.extend.core.Var))
    monkeypatch.setitem(jH._JAXPR_CALLS, "jit", "jaxpr")
    g, cfg, params = tgn_path
    R = 2 * mp.B
    port = mp.step_traffic(g, cfg, params, tier, "cpu")
    pipe = pl.build_pipeline(cfg, use_kernels=tier, device="cpu")
    b = next(iter(stream.fixed_count(g, mp.B, window=slice(0, mp.B))))
    cols = (b.src, b.dst, b.eid, b.ts, b.valid)
    trace = H.record(lambda p, a, s, bt, e: pipe.step(p, a, s, bt, e),
                     params, pipe.prepare(params), pipe.init_state(),
                     tuple(torch.from_numpy(np.ascontiguousarray(c))
                           for c in cols), torch.as_tensor(g.edge_feats))
    ours = _port_classes(trace, R)
    assert sum(ours.values()) == port["bytes"]

    jp = jax.tree.map(jnp.asarray, convert.params_to_numpy(params))
    jpipe = jpl.build_pipeline(jtgn.TGNConfig(**cfg.asdict()),
                               use_kernels=tier)
    aux = jpipe.prepare(jp)
    ef = jnp.asarray(g.edge_feats)

    def step(s, bt):
        return jpipe.step(jp, aux, s, bt, ef)
    args = (jpipe.init_state(),
            tuple(jnp.asarray(np.ascontiguousarray(c)) for c in cols))
    ref = jH.jaxpr_traffic(step, *args, intermediates_only=True)
    theirs = _ref_classes(jax.make_jaxpr(step)(*args), R)
    assert theirs.pop("launches") == ref["pallas_launches"]
    assert sum(theirs.values()) == pytest.approx(ref["bytes"], rel=1e-12)

    assert sum(port["kernel_launches"].values()) == ref["pallas_launches"]
    assert ref["pallas_launches"] == {"staged": 3, "fused": 1, "ref": 0}[
        tier]
    assert ours["pair"] / theirs["pair"] == pytest.approx(
        PAIR_RATIO, rel=NAMED_RTOL)
    if tier in KERNEL_RATIO:
        assert ours["kernel"] / theirs["kernel"] == pytest.approx(
            KERNEL_RATIO[tier], rel=NAMED_RTOL)
    else:
        assert ours["kernel"] == theirs["kernel"] == 0
    assert ours["rest"] == pytest.approx(theirs["rest"], rel=REST_RTOL)


def test_a_kernel_another_thread_calls_is_not_recorded(tgn_path):
    """The active recorder is the recording thread's: a kernel entry
    point called from another thread while a record runs runs as it
    would without one, and the record holds only its own thread's ops."""
    import threading
    from repro_torch.kernels import ops

    dt = torch.linspace(0.0, 50.0, 64)
    packed = {"bounds": torch.linspace(0.0, 60.0, 9),
              "table": torch.randn(9, 4, generator=torch.Generator()
                                   .manual_seed(0))}
    seen = {}

    def other():
        seen["active"] = optrace.ACTIVE.recorder
        seen["out"] = ops.lut_encode(dt, packed)

    def step(x):
        t = threading.Thread(target=other)
        t.start()
        t.join()
        return ops.lut_encode(x, packed)

    trace = H.record(step, dt)
    assert seen["active"] is None
    assert torch.equal(seen["out"], ops.lut_encode(dt, packed))
    assert [e["op"] for e in trace["ops"]] == ["kernel.lut_encode"]
    assert optrace.ACTIVE.recorder is None
