"""The port's LM sharding rules and meshes against the JAX package.

Specs are compared entry by entry: the port's tuple against the
reference's ``PartitionSpec`` as a tuple. Every rule case of the
reference's ``tests/test_sharding.py`` runs on both packages; every arch at
its published config (the reference's ``abstract_params`` through
``jax.eval_shape``, the port's on ``meta``) gets equal leaf paths and
equal parameter and ZeRO-1 specs in both modes. ``place`` is held against
the tile assignment JAX computes for the same ``NamedSharding`` on an
``AbstractMesh`` of the same shape. Meshes are repeats of the CPU.

A test that installs activation rules removes them in a fixture.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.distributed import sharding as jshd
from repro.launch import mesh as jmesh
from repro.models import lm_common as jlm

from repro_torch import configs, tree
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh
from repro_torch.models import lm_common

torch.set_num_threads(1)

ARCHS = configs.all_archs()
MODES = ("tp", "fsdp2d")


class FakeMesh:
    """What the reference's batch and cache specs read of a mesh."""

    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


@pytest.fixture
def rules():
    """Activation rules installed by the test, removed after it on both
    packages whatever the test did."""
    try:
        yield
    finally:
        shd.set_activation_rules({})
        jshd.set_activation_rules({})


# ---------------------------------------------------------------------------
# the reference's rule cases (tests/test_sharding.py:11-64)
# ---------------------------------------------------------------------------

SPEC_CASES = [
    ("params.embed", (49155, 4096), "tp", 16),
    ("params.embed", (262144, 3840), "tp", 16),
    ("blocks.l0.attn.wq", (8, 3840, 4096), "tp", 16),
    ("blocks.l0.mlp.w_up", (8, 6144, 32768), "fsdp2d", 16),
    ("blocks.l0.moe.w_gate", (8, 16, 6144, 10752), "fsdp2d", 16),
    ("blocks.l0.moe.w_gate", (8, 8, 6144, 32768), "fsdp2d", 16),
    ("blocks.l0.moe.w_down", (8, 8, 32768, 6144), "tp", 16),
    ("blocks.l0.moe.w_down", (8, 16, 10752, 6144), "tp", 16),
    ("blocks.l0.moe.router", (8, 6144, 16), "fsdp2d", 16),
    ("head.unembed", (4096, 49155), "fsdp2d", 16),
    ("blocks.l0.rec.w_a", (4, 16, 256, 256), "tp", 16),
    ("blocks.l0.attn.wo", (4096, 4096), "tp", 16),
    ("final_norm.scale", (4096,), "fsdp2d", 16),
    ("dec.pos_dec", (448, 384), "tp", 16),
    ("blocks.l0.attn.wq", (8, 8, 12), "tp", 16),     # nothing divides
]


@pytest.mark.parametrize("path,shape,mode,n_model", SPEC_CASES)
def test_spec_for_equals_the_references(path, shape, mode, n_model):
    assert shd.spec_for(path, shape, mode, n_model) == tuple(
        jshd.spec_for(path, shape, mode, n_model))


def test_spec_divisibility_fallback():
    # vocab 49155 not divisible by 16 -> embed shards d_model instead
    s = shd.spec_for("params.embed", (49155, 4096), "tp", 16)
    assert s == (None, "model")
    # clean vocab shards normally
    assert shd.spec_for("params.embed", (262144, 3840), "tp", 16)[0] == \
        "model"


def test_stacked_scan_dims_padded():
    assert shd.spec_for("blocks.l0.attn.wq", (8, 3840, 4096), "tp",
                        16) == (None, None, "model")


def test_fsdp2d_two_axis():
    assert shd.spec_for("blocks.l0.mlp.w_up", (8, 6144, 32768), "fsdp2d",
                        16) == (None, "data", "model")


def test_moe_expert_parallel_when_divisible():
    s = shd.spec_for("blocks.l0.moe.w_gate", (8, 16, 6144, 10752),
                     "fsdp2d", 16)
    assert s[1] == "model"                              # 16 experts -> EP
    s2 = shd.spec_for("blocks.l0.moe.w_gate", (8, 8, 6144, 32768),
                      "fsdp2d", 16)
    assert s2[1] is None and "model" in s2              # 8 experts -> TP


def test_zero1_adds_dp_axis():
    shape = (8, 4096, 12288)
    ptree = {"blocks": {"mlp": {"w_up": torch.empty(shape, device="meta")}}}
    jtree = {"blocks": {"mlp": {"w_up": jnp.zeros(shape)}}}
    for mode in MODES:
        base = shd.param_specs(ptree, mode, 16)["blocks"]["mlp"]["w_up"]
        z1 = shd.zero1_specs(ptree, mode, 16)["blocks"]["mlp"]["w_up"]
        assert base == tuple(jshd.param_specs(jtree, mode, 16)[
            "blocks"]["mlp"]["w_up"])
        assert z1 == tuple(jshd.zero1_specs(jtree, mode, 16)[
            "blocks"]["mlp"]["w_up"])
    b = shd.param_specs(ptree, "tp", 16)["blocks"]["mlp"]["w_up"]
    z = shd.zero1_specs(ptree, "tp", 16)["blocks"]["mlp"]["w_up"]
    assert "data" not in b and "data" in z and "model" in z


def test_batch_spec_on_the_host_mesh():
    s = shd.batch_spec(mesh.make_host_mesh("cpu"), 8, 2)
    assert len(s) == 2
    assert s == tuple(jshd.batch_spec(jmesh.make_host_mesh(), 8, 2))


def test_cache_spec_seq_over_model():
    fake = FakeMesh({"data": 16, "model": 16})
    for shape, batch in (((8, 128, 32768, 8, 128), 128),
                         ((8, 1, 524288, 8, 128), 1)):
        assert shd.cache_spec(fake, shape, batch) == tuple(
            jshd.cache_spec(fake, shape, batch))
    s = shd.cache_spec(fake, (8, 128, 32768, 8, 128), 128)
    assert s[1] == "data" and s[2] == "model"
    # batch=1: no DP shard, seq still over model
    s1 = shd.cache_spec(fake, (8, 1, 524288, 8, 128), 1)
    assert s1[1] is None and s1[2] == "model"


# ---------------------------------------------------------------------------
# constrain (tests/test_sharding.py:91-95) and its resolution
# ---------------------------------------------------------------------------


def test_constrain_noop_without_rules(rules):
    shd.set_activation_rules({})
    jshd.set_activation_rules({})
    x = torch.zeros((4, 8))
    assert shd.constrain(x, "carry") is x
    assert jshd.constrain(jnp.zeros((4, 8)), "carry").shape == (4, 8)
    assert shd.activation_spec((4, 8), "carry") is None


def _norm(spec) -> tuple:
    """A spec with one-name tuples written as the name (PartitionSpec's
    own normal form)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


@pytest.mark.parametrize("shape,kind", [
    ((4, 8, 3), "carry"), ((3, 6, 5), "carry"), ((2, 12), "carry"),
    ((6, 2), "block_in"), ((5, 4, 4), "block_in")])
def test_constrain_resolves_as_the_reference_and_returns_x(rules, shape,
                                                           kind):
    """With rules installed on a (2, 4) mesh, the port resolves each spec
    as the reference's ``constrain`` does under a mesh of that shape
    (axes that do not divide their dim dropped) and returns ``x`` itself,
    bit for bit."""
    spec = {"carry": (("data",), "model", None), "block_in": ("data", None)}
    m = mesh.TenantMesh(np.asarray([["cpu"] * 4] * 2, dtype=object),
                        ("data", "model"))
    shd.set_activation_rules(spec, m)
    jshd.set_activation_rules({k: P(*v) for k, v in spec.items()})
    with jax.sharding.use_abstract_mesh(AbstractMesh((2, 4),
                                                     ("data", "model"))):
        jaxpr = jax.make_jaxpr(lambda x: jshd.constrain(x, kind))(
            jax.ShapeDtypeStruct(shape, jnp.float32))
    want = tuple(jaxpr.jaxpr.eqns[0].params["sharding"].spec)
    assert _norm(shd.activation_spec(shape, kind)) == _norm(
        want + (None,) * (len(shape) - len(want)))
    x = torch.randn(shape)
    assert shd.constrain(x, kind) is x


# ---------------------------------------------------------------------------
# every arch at its published config
# ---------------------------------------------------------------------------


def _trees(arch):
    jtree = jlm.abstract_params(jconfigs.get(arch).config())
    ptree = lm_common.abstract_params(configs.get(arch).config())
    return jtree, ptree


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_zero1_specs_equal_the_references(arch):
    """Leaf paths (the port's dot paths against the reference's
    ``_path_str``) and, in both modes at n_model = 16, every parameter
    spec and ZeRO-1 spec, leaf by leaf and axis by axis."""
    jtree, ptree = _trees(arch)
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    pflat = tree.flatten_with_path(ptree)
    assert [p for p, _ in pflat] == [jshd._path_str(kp) for kp, _ in jflat]
    assert [tuple(x.shape) for _, x in pflat] == [tuple(x.shape)
                                                  for _, x in jflat]
    for mode in MODES:
        got = tree.leaves(shd.param_specs(ptree, mode, 16),
                          is_leaf=shd._is_spec)
        want = jax.tree.leaves(jshd.param_specs(jtree, mode, 16),
                               is_leaf=lambda x: isinstance(x, P))
        assert got == [tuple(s) for s in want], mode
        got = tree.leaves(shd.zero1_specs(ptree, mode, 16),
                          is_leaf=shd._is_spec)
        want = jax.tree.leaves(jshd.zero1_specs(jtree, mode, 16),
                               is_leaf=lambda x: isinstance(x, P))
        assert got == [tuple(s) for s in want], mode


@pytest.mark.parametrize("multi_pod", [False, True])
def test_batch_and_cache_specs_on_the_production_meshes(multi_pod):
    """``dp_axes``, ``batch_spec`` for every cell's batch and
    ``cache_spec`` for every decoding arch's caches at the decode cells'
    shapes, on the port's production mesh and on the reference's axes of
    the same sizes."""
    m = mesh.make_production_mesh(multi_pod=multi_pod,
                                  devices=["cpu"] * (512 if multi_pod
                                                     else 256))
    fake = FakeMesh(m.shape)
    assert shd.dp_axes(m) == jshd.dp_axes(fake)
    for batch in (1, 16, 32, 128, 256, 48):
        for ndim in (1, 2, 3):
            assert shd.batch_spec(m, batch, ndim) == tuple(
                jshd.batch_spec(fake, batch, ndim))
    for arch in ARCHS:
        pcfg, jcfg = configs.get(arch).config(), jconfigs.get(arch).config()
        if not lm_common.has_decode(pcfg):
            continue
        for name in ("decode_32k", "long_500k"):
            seq, batch, _ = configs.SHAPES[name]
            caches = tree.leaves(lm_common.abstract_caches(pcfg, batch, seq))
            jcaches = jax.tree.leaves(jlm.abstract_caches(jcfg, batch, seq))
            assert [tuple(c.shape) for c in caches] == [
                tuple(c.shape) for c in jcaches], (arch, name)
            for c in caches:
                assert shd.cache_spec(m, tuple(c.shape), batch) == tuple(
                    jshd.cache_spec(fake, tuple(c.shape), batch)), arch


# ---------------------------------------------------------------------------
# meshes and placement
# ---------------------------------------------------------------------------


def test_meshes():
    m = mesh.make_production_mesh(devices=["cpu"] * 256)
    assert m.axis_names == ("data", "model") and m.devices.shape == (16, 16)
    m = mesh.make_production_mesh(multi_pod=True, devices=["cpu"] * 512)
    assert m.axis_names == ("pod", "data", "model")
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    with pytest.raises(RuntimeError, match="needs 256 devices"):
        mesh.make_production_mesh(devices=["cpu"] * 255)
    h = mesh.make_host_mesh("cpu")
    assert h.shape == {"data": 1, "model": 1}
    assert h.devices[0, 0] == torch.device("cpu")


def test_host_mesh_and_production_mesh_need_cuda_unless_given(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.make_host_mesh()
    with pytest.raises(RuntimeError, match="found 0"):
        mesh.make_production_mesh()


def _jax_pieces(mesh_shape, axis_names, spec, shape):
    """Per mesh position (row-major), the slices of its piece, read off
    the tile assignment JAX gives ``NamedSharding(mesh, spec)``."""
    js = JNamedSharding(AbstractMesh(mesh_shape, axis_names),
                        P(*spec))
    hlo = js._to_xla_hlo_sharding(len(shape))
    n = int(np.prod(mesh_shape))
    if hlo.is_replicated():
        return [tuple(slice(0, d) for d in shape)] * n
    dims = hlo.tile_assignment_dimensions()
    tiles = np.asarray(hlo.tile_assignment_devices()).reshape(dims)
    out = [None] * n
    for coord in np.ndindex(*dims):
        idx = coord[:len(shape)]
        out[tiles[coord]] = tuple(
            slice(i * (d // dims[k]), (i + 1) * (d // dims[k]))
            for k, (i, d) in enumerate(zip(idx, shape)))
    return out


PLACE_CASES = [
    ((2, 2), (None, "model")),
    ((2, 2), ("model", "data")),
    ((2, 2), ("data", None, "model")),
    ((2, 2), (("data", "model"), None)),
    ((2, 2), (("model", "data"), None, None)),
    ((2, 2), (None, None)),
    ((16, 16), ("data", "model")),
    ((16, 16), (None, "model", "data")),
    ((16, 16), (("data", "model"),)),
]


@pytest.mark.parametrize("mesh_shape,spec", PLACE_CASES)
def test_place_gives_the_pieces_the_spec_implies(mesh_shape, spec):
    axes = ("data", "model")
    shape = {1: (512,), 2: (32, 48), 3: (16, 32, 32)}[len(spec)]
    t = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    m = mesh.TenantMesh(np.asarray(["cpu"] * int(np.prod(mesh_shape)),
                                   dtype=object).reshape(mesh_shape), axes)
    placed = shd.NamedSharding(m, spec).place(t)
    if all(e is None for e in spec):
        assert placed is t          # nothing split: the tensor itself
        return
    assert isinstance(placed, shd.ShardedTensor)
    assert placed.shards.shape == mesh_shape
    want = _jax_pieces(mesh_shape, axes, spec, shape)
    for k, pos in enumerate(np.ndindex(*mesh_shape)):
        piece = placed.shards[pos]
        assert torch.equal(piece, t[want[k]]), pos
        # a view of the one copy on its device (here: ``t`` itself)
        assert piece.untyped_storage().data_ptr() == \
            t.untyped_storage().data_ptr()
    assert placed.shard_shape == shd.shard_shape(shape, spec, m)
    # positions holding the same piece share one tensor
    distinct = {id(p) for p in placed.shards.reshape(-1)}
    assert len(distinct) == len({tuple((s.start, s.stop) for s in w)
                                 for w in want})
    assert torch.equal(placed.full(), t)


def test_place_refuses_a_dim_the_mesh_does_not_divide():
    m = mesh.TenantMesh(np.asarray([["cpu"] * 3] * 2, dtype=object),
                        ("data", "model"))
    with pytest.raises(ValueError, match="does not split"):
        shd.NamedSharding(m, (None, "model")).place(torch.zeros(4, 8))


@pytest.mark.parametrize("arch", ["qwen3_8b", "grok_1_314b"])
def test_per_device_bytes_by_spec_arithmetic(arch):
    """Per-device bytes of the published config on (16, 16): the sum of
    each leaf's piece, which is the leaf over the product of the sizes of
    the axes its spec names."""
    ptree = lm_common.abstract_params(configs.get(arch).config())
    m = mesh.make_production_mesh(devices=["meta"] * 256)
    for mode in MODES:
        specs = shd.param_specs(ptree, mode, 16)
        want = 0
        for leaf, spec in zip(tree.leaves(ptree),
                              tree.leaves(specs, is_leaf=shd._is_spec)):
            div = 1
            for e in spec:
                for a in (e if isinstance(e, tuple) else (e,)):
                    div *= m.shape.get(a, 1) if a else 1
            want += leaf.numel() * leaf.element_size() // div
        assert shd.per_device_bytes(ptree, specs, m) == want
        total = sum(x.numel() * x.element_size() for x in tree.leaves(ptree))
        assert want < total


@pytest.mark.parametrize("multi_pod", [False, True])
def test_shard_bytes_is_the_spec_arithmetic_of_both_trees(multi_pod):
    """``mesh.shard_bytes``: the parameters by ``param_specs``, the two
    fp32 moments by ``zero1_specs``; the rules never name ``pod``, so the
    multi-pod mesh holds what the single-pod one does."""
    cfg = configs.get("dbrx_132b").config()
    p = lm_common.abstract_params(cfg)
    m = mesh.make_production_mesh(multi_pod=multi_pod,
                                  devices=["meta"] * 512)
    single = mesh.make_production_mesh(devices=["meta"] * 256)
    for mode in MODES:
        got = mesh.shard_bytes(cfg, mode, m)
        assert got["params"] == shd.per_device_bytes(
            p, shd.param_specs(p, mode, 16), m)
        assert got["moments"] == 2 * shd.per_device_bytes(
            p, shd.zero1_specs(p, mode, 16), m, itemsize=4)
        assert got == mesh.shard_bytes(cfg, mode, single)
