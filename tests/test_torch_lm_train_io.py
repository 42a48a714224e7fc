"""The port's language-model training plumbing against the JAX package and
on its own: int8 error-feedback compression and the compressed all-reduce,
the input, cache and parameter specs, checkpoints of a training run (the
reference's restart-determinism test on the port, and a checkpoint the
reference's train loop wrote, restored and continued in the port), the
training CLI's ``--mode lm``, and ``launch/lm_train_smoke.py``'s checks
driven at the smoke widths on the CPU.

Compression is integer arithmetic on equal fp32 inputs, so payloads,
scales and outputs are held bitwise; a resumed run is held bitwise to an
uninterrupted one, as the reference promises.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.distributed import checkpoint as jckpt
from repro.distributed import compression as jcomp
from repro.models import lm_common as jlm
from repro.models import transformer as jT
from repro.training import optim as jopt
from repro.training import train_loop as jTL
from repro.training.lr_schedule import ScheduleConfig as jSchedule

from repro_torch import configs, convert, tree
from repro_torch.core import perf_model
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import compression
from repro_torch.launch import lm_train_smoke as LTS
from repro_torch.launch import train as train_cli
from repro_torch.models import lm_common, transformer
from repro_torch.training import optim, train_loop as TL
from repro_torch.training.lr_schedule import ScheduleConfig

torch.set_num_threads(1)

ARCHS = configs.all_archs()
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# int8 error-feedback compression
# ---------------------------------------------------------------------------


def _grad_tree(rng):
    # 300 and 7 entries: blocks of 256 padded
    return {"a": {"w": rng.randn(30, 10).astype(np.float32) * 3,
                  "b": rng.randn(7).astype(np.float32) * 1e-3},
            "c": np.zeros((4, 4), np.float32)}


def test_block_quant_payloads_and_scales_equal_the_references():
    rng = np.random.RandomState(0)
    x = rng.randn(1000).astype(np.float32)
    x[::97] = 0.5 * np.float32(np.abs(x).max()) / 127 * 3  # half steps
    q, scale, n = compression._block_quant(torch.as_tensor(x))
    jq, jscale, jn = jcomp._block_quant(jnp.asarray(x))
    assert n == jn and q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))


def test_ef_int8_roundtrip_equals_the_reference_over_three_rounds():
    rng = np.random.RandomState(0)
    r = jr = None
    for _ in range(3):
        g = _grad_tree(rng)
        g_hat, r = compression.ef_int8_roundtrip(
            tree.map(torch.as_tensor, g), r)
        jg_hat, jr = jcomp.ef_int8_roundtrip(jax.tree.map(jnp.asarray, g),
                                             jr)
        for a, b in zip(tree.leaves(g_hat) + tree.leaves(r),
                        jax.tree.leaves(jg_hat) + jax.tree.leaves(jr)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_ef_residual_property():
    """error feedback: g_hat + r_new == g + r_old (the reference's
    ``test_compression_ef_residual_property``, on the port)."""
    rng = np.random.RandomState(0)
    g = {"w": torch.as_tensor(rng.randn(40, 7).astype(np.float32))}
    r = {"w": torch.as_tensor(rng.randn(40, 7).astype(np.float32)) * 0.1}
    g_hat, r_new = compression.ef_int8_roundtrip(g, r)
    np.testing.assert_allclose((g_hat["w"] + r_new["w"]).numpy(),
                               (g["w"] + r["w"]).numpy(), rtol=1e-5,
                               atol=1e-6)


def test_compressed_psum_equals_the_reference_under_vmap():
    """Four members: the shared scale, the int32 sum and the dequantized
    total equal the reference's ``compressed_psum`` under ``jax.vmap``
    with a named axis (``pmax`` / ``psum`` over the mapped axis), and lie
    within half a quantum a member of the exact sum."""
    rng = np.random.RandomState(0)
    xs = rng.randn(4, 33, 17).astype(np.float32)
    xs[2] *= 10.0
    want = jax.vmap(lambda x: jcomp.compressed_psum(x, "i"),
                    axis_name="i")(jnp.asarray(xs))
    got = compression.compressed_psum([torch.as_tensor(x) for x in xs])
    for member in np.asarray(want):
        np.testing.assert_array_equal(got.numpy(), member)
    quantum = np.abs(xs).max() / 127.0
    assert np.abs(got.numpy() - xs.sum(0)).max() <= 4 * 0.5 * quantum


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


def _specs_equal(got, want):
    """A tree of meta tensors against a tree of ShapeDtypeStructs: the same
    paths, shapes and dtypes."""
    want_paths = jckpt._leaf_paths(want)
    assert tree.leaf_paths(got) == want_paths
    for path, g, w in zip(want_paths, tree.leaves(got),
                          jax.tree.leaves(want)):
        assert g.device.type == "meta", path
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), path


@pytest.mark.parametrize("arch", ARCHS)
def test_train_and_decode_input_specs_equal_the_references(arch):
    jcfg, tcfg = jconfigs.get(arch).smoke_config(), configs.get(
        arch).smoke_config()
    _specs_equal(lm_common.train_inputs(tcfg, 2, 32),
                 jlm.train_inputs(jcfg, 2, 32))
    _specs_equal(lm_common.decode_inputs(tcfg, 2, 32),
                 jlm.decode_inputs(jcfg, 2, 32))
    _specs_equal(lm_common.abstract_caches(tcfg, 3, 16),
                 jlm.abstract_caches(jcfg, 3, 16))
    zeros = lm_common.train_inputs(tcfg, 2, 32, abstract=False,
                                   device="cpu")
    for k, v in zeros.items():
        assert v.device.type == "cpu" and not bool(v.any()), k
    dec = lm_common.decode_inputs(tcfg, 1, 8, abstract=False, device="cpu")
    assert all(t.device.type == "cpu" for t in tree.leaves(dec))


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_equal_the_references_at_full_size(arch):
    """The published configs' parameter trees, shapes and dtypes, with
    nothing allocated on either side."""
    jcfg, tcfg = jconfigs.get(arch).config(), configs.get(arch).config()
    _specs_equal(lm_common.abstract_params(tcfg), jlm.abstract_params(jcfg))


def test_materialized_inputs_need_cuda_unless_the_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get("qwen3_8b").smoke_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_common.train_inputs(cfg, 2, 8, abstract=False)


# ---------------------------------------------------------------------------
# bf16 compute
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3_8b", "mamba2_130m", "whisper_tiny"])
def test_bf16_loss_and_gradients_match_the_reference_within_bf16(arch):
    """The smoke configs in bf16 (the published configs' dtype). The port
    gathers embedding rows and then casts them, so the embedding's
    gradient sums a token's repeats in fp32 where the reference (cast,
    then gather) sums them in bf16; every other product rounds to bf16 as
    the reference's does, in another order. The loss is held to rtol 1e-3
    and each gradient leaf, the embedding's too, to a relative L2 error
    of 0.05 (2^-8 = 0.4% a rounding, compounded through the layers and
    back; they read <= 0.025, the embedding's <= 0.016). MoE is left out:
    a router logit that rounds the other way sends a token to another
    expert."""
    jcfg = jconfigs.get(arch).smoke_config().replace(dtype="bfloat16")
    cfg = configs.get(arch).smoke_config().replace(dtype="bfloat16")
    jp = jlm.init_params(jax.random.key(0), jcfg)
    p = convert.params_from_reference(jax.tree.map(np.asarray, jp), CPU)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, jcfg.vocab, (2, 64)).astype(np.int32)
    b = {"tokens": toks, "targets": np.roll(toks, -1, 1)}
    if arch == "whisper_tiny":
        b["frames"] = rng.randn(2, jcfg.n_frames,
                                jcfg.d_model).astype(np.float32)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda q, x: jlm.loss_fn(q, jcfg, x)))(
            jp, jax.tree.map(jnp.asarray, b))
    loss, grads = LTS.loss_and_grads(cfg, p, {k: torch.as_tensor(v)
                                              for k, v in b.items()})
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-3)
    want = convert.params_from_reference(jax.tree.map(np.asarray, jg), CPU)
    worst, where = LTS.rel_l2(grads, want)
    assert worst <= 0.05, where


# ---------------------------------------------------------------------------
# checkpoints of a training run
# ---------------------------------------------------------------------------

TINY = dict(arch="t", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
            d_head=16, d_ff=64, vocab=64, dtype="float32", q_block=16,
            k_block=16, loss_chunk=16)


def _tiny_batch(i):
    rng = np.random.RandomState(100 + i)
    t = rng.randint(0, 64, (2, 32)).astype(np.int32)
    return {"tokens": t, "targets": np.roll(t, -1, 1)}


def test_lm_restart_determinism(tmp_path):
    """Kill-and-resume == uninterrupted run, bitwise on the parameters (the
    reference's ``test_lm_restart_determinism``, on the port)."""
    cfg = transformer.LMConfig(**TINY)
    tcfg = TL.TrainConfig(optim=optim.OptimConfig(lr=1e-3),
                          sched=ScheduleConfig(warmup_steps=2,
                                               total_steps=10))
    step_fn = TL.make_train_step(lambda p, b: lm_common.loss_fn(p, cfg, b),
                                 tcfg)

    def batch_at(i):
        return {k: torch.as_tensor(v) for k, v in _tiny_batch(i).items()}

    p0 = lm_common.init_params(torch.Generator().manual_seed(0), cfg, CPU)
    o0 = TL.init_train_state(tcfg, p0)
    p_full, o_full = p0, o0
    for i in range(10):
        p_full, o_full, _ = step_fn(p_full, o_full, batch_at(i), i)
    p, o = p0, o0
    for i in range(5):
        p, o, _ = step_fn(p, o, batch_at(i), i)
    ckpt.save(str(tmp_path), 5, {"params": p, "opt": o})
    state, _ = ckpt.restore(str(tmp_path), {"params": p0, "opt": o0},
                            device="cpu")
    p, o = state["params"], state["opt"]
    for i in range(5, 10):
        p, o, _ = step_fn(p, o, batch_at(i), i)
    for a, b in zip(tree.leaves(p_full), tree.leaves(p)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_reference_lm_checkpoint_restores_and_continues_bitwise(tmp_path,
                                                               moments):
    """Three steps of the reference's jitted train step, saved by the
    reference: the port restores every leaf bit for bit (int8 moments as
    their payload and scale), and its next two steps from the restored
    state equal its steps from the reference's state converted in
    memory."""
    jcfg, cfg = jT.LMConfig(**TINY), transformer.LMConfig(**TINY)
    jt = jTL.TrainConfig(optim=jopt.OptimConfig(lr=1e-3,
                                                moment_dtype=moments),
                         sched=jSchedule(warmup_steps=2, total_steps=10))
    tcfg = TL.TrainConfig(optim=optim.OptimConfig(**jt.optim.asdict()),
                          sched=ScheduleConfig(**jt.sched.asdict()))
    jstep = jax.jit(jTL.make_train_step(
        lambda p, b: jlm.loss_fn(p, jcfg, b), jt))
    jp = jlm.init_params(jax.random.key(0), jcfg)
    jo = jTL.init_train_state(jt, jp)
    for i in range(3):
        jp, jo, _ = jstep(jp, jo, jax.tree.map(jnp.asarray, _tiny_batch(i)),
                          i)
    jckpt.save(str(tmp_path), 3, {"params": jp, "opt": jo})

    like = {"params": lm_common.abstract_params(cfg)}
    like["opt"] = TL.init_train_state(tcfg, like["params"])
    state, _ = ckpt.restore(str(tmp_path), like, device="cpu")
    mem = {"params": convert.params_from_reference(jax.tree.map(
        np.asarray, jp), CPU),
        "opt": convert.opt_state_from_reference(jax.tree.map(
            np.asarray, jo), CPU)}
    assert tree.leaf_paths(state) == tree.leaf_paths(mem)
    for path, a, b in zip(tree.leaf_paths(state), tree.leaves(state),
                          tree.leaves(mem)):
        assert a.dtype == b.dtype and torch.equal(a, b), path

    step_fn = TL.make_train_step(lambda p, b: lm_common.loss_fn(p, cfg, b),
                                 tcfg)
    runs = []
    for start in (state, mem):
        p, o = start["params"], start["opt"]
        for i in range(3, 5):
            p, o, m = step_fn(p, o, {k: torch.as_tensor(v) for k, v in
                                     _tiny_batch(i).items()}, i)
        runs.append((p, o, float(m["loss"])))
    assert runs[0][2] == runs[1][2]
    assert LTS.trees_equal(runs[0][:2], runs[1][:2])


# ---------------------------------------------------------------------------
# the CLI's --mode lm
# ---------------------------------------------------------------------------


def test_mode_lm_needs_cuda_unless_the_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--mode", "lm", "--steps", "1", "--batch", "2",
                        "--seq", "16"])


def test_mode_lm_trains_every_family_on_the_cpu(capsys):
    """``--mode lm`` with ``--device cpu`` takes its steps at each family's
    smoke config, with grad accumulation, and logs the reference's
    lines."""
    for arch in ("qwen3_8b", "mamba2_130m", "whisper_tiny",
                 "recurrentgemma_9b", "llama32_vision_11b"):
        out = train_cli.main(["--mode", "lm", "--arch", arch, "--steps",
                              "2", "--batch", "4", "--seq", "32",
                              "--grad-accum", "2", "--log-every", "1",
                              "--device", "cpu"])
        assert len(out["losses"]) == 2 and out["start"] == 0
        assert all(np.isfinite(out["losses"]))
    lines = capsys.readouterr().out.splitlines()
    assert any(ln.startswith("step 2: loss=") for ln in lines)
    assert lines[-1].startswith("[lm] final loss ")


def test_mode_lm_on_the_cpu_killed_and_resumed_is_bitwise(monkeypatch):
    """The CLI run as its own process, killed once its step-3 checkpoint is
    committed, and rerun: it resumes from step 3 and ends with the bits
    of an uninterrupted run (``lm_train_smoke.cli_resume``). The processes
    run with one OpenMP / MKL thread, as this one does: a thread a core
    beside the other test workers leaves each small op waiting on
    descheduled threads."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("MKL_NUM_THREADS", "1")
    out = LTS.cli_resume(CPU, "cpu", dict(arch="qwen3_8b", steps=6,
                                          ckpt_every=3, batch=2, seq=64))
    assert out == {"resumed": True, "equal": True}


def test_mode_lm_resumes_from_the_newest_valid_checkpoint(tmp_path):
    """In process: a run whose last checkpoint is lost (a kill before it
    was committed) resumes from the one before, bitwise; a corrupt newest
    checkpoint is skipped for the one before it."""
    args = ["--mode", "lm", "--arch", "mamba2_130m", "--steps", "6",
            "--batch", "2", "--seq", "32", "--ckpt-every", "2",
            "--device", "cpu", "--log-every", "100"]
    whole = train_cli.main(args + ["--ckpt", str(tmp_path / "a")])
    train_cli.main(args + ["--ckpt", str(tmp_path / "b")])
    shutil.rmtree(tmp_path / "b" / "step_00000006")
    with open(tmp_path / "b" / "step_00000004" / "arr_00000.npy", "r+b") as f:
        f.seek(200)
        f.write(b"\x00\x01\x02\x03")
    with pytest.warns(UserWarning, match="corrupt"):
        resumed = train_cli.main(args + ["--ckpt", str(tmp_path / "b")])
    assert resumed["start"] == 2
    assert resumed["losses"] == whole["losses"][2:]
    assert LTS.trees_equal(resumed["params"], whole["params"])
    assert LTS.trees_equal(resumed["opt"], whole["opt"])


# ---------------------------------------------------------------------------
# lm_train_smoke at the smoke widths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("label,kw", [("", {}),
                                      ("grad_accum=2", {"grad_accum": 2}),
                                      ("compress_grads",
                                       {"compress_grads": True})])
def test_train_smoke_step_on_the_cpu(label, kw):
    out = LTS.smoke_step("dbrx_132b", configs.get("dbrx_132b").smoke_config(),
                         CPU, "cpu", label, **kw)
    assert out == {"loss": 0.0, "grads": 0.0, "params": 0.0}


def test_step_param_limit_holds_under_gradients_within_their_limit():
    """``step_param_ratio``'s bound: AdamW's first step from gradients that
    differ by up to 0.9 of the gradient limit, entry by entry, stays within
    it, and a parameter moved by 4 lr does not."""
    cfg = configs.get("qwen3_8b").smoke_config()
    p = lm_common.init_params(torch.Generator().manual_seed(0), cfg, CPU)
    batch = LTS.batch_on(cfg, 0, 2, 32, CPU)
    _, g = LTS.loss_and_grads(cfg, p, batch)
    atol = LTS.GRAD_ATOL_SCALE * max(float(x.abs().max())
                                     for x in tree.leaves(g))
    gen = torch.Generator().manual_seed(1)
    g2 = tree.map(lambda x: x + 0.9 * (LTS.GRAD_RTOL * x.abs() + atol) * (
        2 * torch.randint(0, 2, x.shape, generator=gen) - 1), g)
    tcfg = LTS.lm_step_config(1)
    state = optim.init_state(tcfg.optim, p)
    lr_scale = torch.tensor(1.0)
    _, p1 = optim.apply_updates(tcfg.optim, state, g, p, lr_scale)
    _, p2 = optim.apply_updates(tcfg.optim, state, g2, p, lr_scale)
    ratio, where = LTS.step_param_ratio(p2, p1, g, tcfg)
    assert ratio <= 1.0, where
    bad = tree.map(lambda x: x.clone(), p2)
    bad["final_norm"]["scale"][3] += 4 * tcfg.optim.lr
    assert LTS.step_param_ratio(bad, p1, g, tcfg)[0] > 1.0


def test_train_mamba_at_smoke_width_catches_the_planted_exponent():
    cfg = configs.get("mamba2_130m").smoke_config().replace(chunk=32)
    out = LTS.train_mamba(cfg, CPU, "cpu", dict(batch=2, seq=64, steps=2,
                                               cpu_batch=1, cpu_seq=32))
    assert out["planted_nonfinite"] > 0
    assert out["cpu_loss"] == 0.0 and out["cpu_grad"] == 0.0
    assert all(np.isfinite(out["losses"]))


def test_train_qwen_at_smoke_width_holds_remat_resume_and_the_plant():
    out = LTS.train_qwen(configs.get("qwen3_8b").smoke_config(), CPU, "cpu",
                         dict(batch=1, seq=64, steps=3, ckpt_after=2))
    assert out["remat_equal"] and out["steps_equal"] and out["resume_equal"]
    assert out["elastic_equal"]
    assert out["one_block_err"] < 1e-5
    assert out["planted_err"] > LTS.BF16_GRAD_REL


def test_step_bound_counts_the_products_attention_and_adamw_bytes():
    cfg = configs.get("qwen3_8b").config().replace(n_layers=4)
    ms, g16, g32, gb = LTS.step_bound_ms(cfg, 1, 4096, False)
    n, emb = cfg.n_params, cfg.vocab * cfg.d_model
    T = 4096
    assert g16 * 1e9 == pytest.approx(6 * (n - emb) * T
                                      + 2 * (n - emb - cfg.d_model) * T)
    assert g32 * 1e9 == pytest.approx(4 * 4 * T * T * 32 * 128 * 4)
    assert gb * 1e9 == pytest.approx(28 * n)
    chip = perf_model.H100_SXM
    assert ms == pytest.approx(
        (g16 / chip.bf16_flops + g32 / chip.fp32_flops) * 1e12)
    assert 100 < ms < 140
    assert LTS.step_bound_ms(cfg, 1, 4096, True)[2] == pytest.approx(
        g32 * 5 / 4)
