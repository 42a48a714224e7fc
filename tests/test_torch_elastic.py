"""Elastic resume and remesh on the port, against the JAX package and
against an uninterrupted run.

``elastic.resume`` restores a checkpoint the reference wrote onto the
host mesh array for array equal to the reference's ``resume`` (the
reference's ``tests/test_checkpoint.py:125`` on both packages), and onto
a (2, 2) mesh of CPU repeats as the pieces its specs imply. A training
run checkpointed at step 5, resumed onto a mesh and remeshed to other
specs, takes steps 6-10 bit for bit as the uninterrupted run does (the
port's ``test_lm_restart_determinism`` with the elastic path in it).
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.distributed import checkpoint as jckpt
from repro.distributed import elastic as jelastic
from repro.launch import mesh as jmesh
from repro.models import lm_common as jlm

from repro_torch import configs, tree
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import elastic
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh
from repro_torch.models import lm_common, transformer
from repro_torch.training import optim, train_loop as TL
from repro_torch.training.lr_schedule import ScheduleConfig

torch.set_num_threads(1)

CPU = torch.device("cpu")
TINY = dict(arch="t", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
            d_head=16, d_ff=64, vocab=64, dtype="float32", q_block=16,
            k_block=16, loss_chunk=16)


def _cpu_mesh(shape):
    return mesh.TenantMesh(np.asarray(["cpu"] * int(np.prod(shape)),
                                      dtype=object).reshape(shape),
                           ("data", "model"))


def _logical(x) -> torch.Tensor:
    return x.full() if isinstance(x, shd.ShardedTensor) else x


@pytest.mark.parametrize("arch", ["qwen3_8b", "dbrx_132b", "mamba2_130m"])
def test_resume_equals_the_references_on_the_host_mesh(tmp_path, arch):
    """A smoke-config parameter tree saved by the reference: the port's
    ``resume`` onto ``make_host_mesh("cpu")`` gives every leaf equal to the
    reference's ``resume`` onto its host mesh, in both modes, as tensors
    on the mesh's device (nothing splits on a (1, 1) mesh)."""
    jp = jlm.init_params(jax.random.key(0),
                         jconfigs.get(arch).smoke_config())
    jckpt.save(str(tmp_path), 4, jp)
    like = lm_common.abstract_params(configs.get(arch).smoke_config())
    for mode in ("tp", "fsdp2d"):
        want, _ = jelastic.resume(str(tmp_path), jp, jmesh.make_host_mesh(),
                                  mode)
        got, meta = elastic.resume(str(tmp_path), like,
                                   mesh.make_host_mesh("cpu"), mode)
        assert meta == {}
        for path, a, b in zip(tree.leaf_paths(got), tree.leaves(got),
                              jax.tree.leaves(want)):
            assert isinstance(a, torch.Tensor) and a.device == CPU
            b = np.asarray(b)
            if a.dtype == torch.bfloat16:
                a = a.float()
            np.testing.assert_array_equal(a.numpy(), b.astype(
                a.numpy().dtype), err_msg=f"{mode} {path}")


def test_resume_onto_a_2x2_mesh_places_the_specs_pieces(tmp_path):
    """The same checkpoint onto a (2, 2) mesh in fsdp2d: each leaf the
    specs split comes back as its pieces, which reassemble to the
    reference's array; each position's piece has the spec's shape."""
    arch = "qwen3_8b"
    jp = jlm.init_params(jax.random.key(0),
                         jconfigs.get(arch).smoke_config())
    jckpt.save(str(tmp_path), 1, jp)
    like = lm_common.abstract_params(configs.get(arch).smoke_config())
    m = _cpu_mesh((2, 2))
    got, _ = elastic.resume(str(tmp_path), like, m, "fsdp2d")
    specs = tree.leaves(shd.param_specs(like, "fsdp2d", 2),
                        is_leaf=shd._is_spec)
    n_split = 0
    for a, b, spec in zip(tree.leaves(got), jax.tree.leaves(jp), specs):
        if isinstance(a, shd.ShardedTensor):
            n_split += 1
            assert a.shard_shape == shd.shard_shape(tuple(b.shape), spec, m)
        np.testing.assert_array_equal(
            _logical(a).float().numpy(), np.asarray(b).astype(np.float32))
    assert n_split > 0


def _batch(i):
    rng = np.random.RandomState(100 + i)
    t = rng.randint(0, 64, (2, 32)).astype(np.int32)
    return {"tokens": torch.as_tensor(t),
            "targets": torch.as_tensor(np.roll(t, -1, 1))}


@pytest.mark.parametrize("route", ["host", "2x2"])
def test_lm_step_after_resume_and_remesh_is_bitwise(tmp_path, route):
    """Steps 6-10 from a step-5 checkpoint equal the uninterrupted run's
    bit for bit. ``host``: resumed onto the host mesh in tp, the live
    state remeshed to the fsdp2d specs on it. ``2x2``: resumed onto a
    (2, 2) mesh in fsdp2d (the split leaves in pieces), remeshed onto the
    host mesh in tp, where the step runs."""
    cfg = transformer.LMConfig(**TINY)
    tcfg = TL.TrainConfig(optim=optim.OptimConfig(lr=1e-3),
                          sched=ScheduleConfig(warmup_steps=2,
                                               total_steps=10))
    step_fn = TL.make_train_step(lambda p, b: lm_common.loss_fn(p, cfg, b),
                                 tcfg)
    p0 = lm_common.init_params(torch.Generator().manual_seed(0), cfg, CPU)
    o0 = TL.init_train_state(tcfg, p0)
    p_full, o_full = p0, o0
    for i in range(10):
        p_full, o_full, _ = step_fn(p_full, o_full, _batch(i), i)
    p, o = p0, o0
    for i in range(5):
        p, o, _ = step_fn(p, o, _batch(i), i)
    ckpt.save(str(tmp_path), 5, {"params": p, "opt": o})
    like = {"params": lm_common.abstract_params(cfg)}
    like["opt"] = TL.init_train_state(tcfg, like["params"])

    host = mesh.make_host_mesh("cpu")
    if route == "host":
        state, _ = elastic.resume(str(tmp_path), like, host, "tp", step=5)
        state = elastic.remesh(state, host,
                               shd.param_specs(like, "fsdp2d", 1))
    else:
        state, _ = elastic.resume(str(tmp_path), like, _cpu_mesh((2, 2)),
                                  "fsdp2d", step=5)
        assert any(isinstance(x, shd.ShardedTensor)
                   for x in tree.leaves(state))
        state = elastic.remesh(state, host, shd.param_specs(like, "tp", 1))
    assert all(isinstance(x, torch.Tensor) for x in tree.leaves(state))
    p, o = state["params"], state["opt"]
    for i in range(5, 10):
        p, o, _ = step_fn(p, o, _batch(i), i)
    for a, b in zip(tree.leaves(p_full) + tree.leaves(o_full),
                    tree.leaves(p) + tree.leaves(o)):
        assert torch.equal(a, b)


def test_remesh_moves_pieces_between_meshes_and_copies():
    """Live tensors through the host onto another mesh: (2, 2) pieces to
    (1, 4) pieces to the host mesh, the logical values unchanged, and the
    result never aliases its input."""
    cfg = transformer.LMConfig(**TINY)
    p = lm_common.init_params(torch.Generator().manual_seed(1), cfg, CPU)
    a = elastic.remesh(p, _cpu_mesh((2, 2)),
                       shd.param_specs(p, "fsdp2d", 2))
    b = elastic.remesh(a, _cpu_mesh((1, 4)), shd.param_specs(p, "tp", 4))
    c = elastic.remesh(b, mesh.make_host_mesh("cpu"),
                       shd.param_specs(p, "tp", 1))
    assert any(isinstance(x, shd.ShardedTensor) for x in tree.leaves(a))
    assert any(isinstance(x, shd.ShardedTensor) for x in tree.leaves(b))
    for x, y in zip(tree.leaves(p), tree.leaves(c)):
        assert isinstance(y, torch.Tensor) and torch.equal(x, y)
        assert y.untyped_storage().data_ptr() != \
            x.untyped_storage().data_ptr()
