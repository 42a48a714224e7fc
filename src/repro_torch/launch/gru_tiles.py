"""Device time of the port's kernels for other tile shapes.

    PYTHONPATH=src python -m repro_torch.launch.gru_tiles

Three sweeps, each at the main path's shapes with seeded inputs, each shape
compiled from a copy of ``kernels/csrc/common.cuh`` with its constants,
with nvcc into ``build/repro_torch/gru_tiles/``, all at once:

- the GRU update (``rt::gru_update``; ``SHAPES``: m16 row tiles a block,
  warps a block, k8 steps a warp per stage, cp.async ring stages), built
  from ``gru_cell.cu`` and run as ``gru_cell`` (R = 400 rows, f_mail =
  372, f_mem = 100) beside ``torch.gru_cell``;
- the SAT Embedding Unit (``rt::sat_eu``; ``EU_SHAPES``: m16 row tiles a
  block, n8 column tiles a block, warps, k8 steps a warp per stage,
  stages) and fused_step's output transform (``OUT_SHAPES``, the same
  five constants of its ``rt::tc_tile``), built from ``sat_aggregate.cu``
  and ``fused_step.cu`` and run as ``sat_aggregate`` (B = 400, k = 4,
  Dkv = 272, D = 100) and ``fused_step`` (the main path's fused step on
  a Wikipedia-sized graph); an EU shape keeps the committed output
  transform, and the reverse;
- lut_encode's block (``LUT_SHAPES``: rows a block, copies a lane issues
  before its stores), built from ``lut_encode.cu`` and run at R = 400
  rows, E = 128, D = 300 beside the empty kernel of the same grid
  (``rt_noop``, the launch floor); its result must equal the plain
  version.

Each shape's weights are packed at its own stage depth and column tile,
its result is checked against the plain version (rtol = atol = 1e-5), and
its device time per call is printed from CUDA-graph replays, over two
rounds (the shapes in order, then reversed). The first shape of each list
is the committed one. Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import contextlib
import ctypes
import re
import shutil
import subprocess
from unittest import mock

import numpy as np
import torch

from repro_torch.kernels import build, ops
from repro_torch.launch import main_path
from repro_torch.utils import resolve_device

#: (kGruMTiles, kGruWarps, kGruKSteps, kGruStages); the first is the
#: committed shape.
SHAPES = [(1, 4, 2, 3), (1, 4, 2, 4), (1, 4, 1, 3), (1, 4, 4, 3),
          (1, 2, 2, 4), (1, 2, 4, 4), (1, 8, 1, 3), (1, 8, 1, 4),
          (2, 4, 1, 3), (2, 4, 2, 3), (2, 8, 1, 3), (2, 8, 1, 4),
          (1, 4, 2, 6), (2, 8, 1, 6)]
CONSTANTS = ("kGruMTiles", "kGruWarps", "kGruKSteps", "kGruStages")
R, F, M = 400, 372, 100

#: (MTiles, NTiles, Warps, KSteps, Stages) of EuShape and of OutShape;
#: the first of each is the committed shape.
EU_SHAPES = [(2, 7, 8, 1, 4), (2, 7, 8, 1, 3), (2, 7, 8, 1, 2),
             (1, 13, 4, 1, 3), (1, 13, 8, 1, 3), (1, 7, 4, 1, 3),
             (1, 7, 8, 1, 3), (1, 4, 4, 1, 3), (1, 4, 8, 1, 3),
             (1, 1, 4, 2, 3), (2, 7, 4, 1, 3), (2, 7, 4, 2, 3),
             (2, 4, 4, 1, 3), (2, 4, 8, 1, 3), (2, 13, 8, 1, 3),
             (4, 4, 8, 1, 3), (4, 7, 8, 1, 3)]
OUT_SHAPES = [(1, 1, 8, 1, 3), (1, 1, 4, 2, 3), (1, 1, 4, 1, 3),
              (1, 1, 2, 2, 4), (1, 2, 4, 1, 3), (1, 4, 4, 1, 3)]
TC_CONSTANTS = ("MTiles", "NTiles", "Warps", "KSteps", "Stages")
TOL = dict(rtol=1e-5, atol=1e-5)

#: (kLutWarps, kLutPass) of lut_encode; the first is the committed shape.
LUT_SHAPES = [(4, 4), (1, 4), (2, 4), (8, 4), (16, 4), (4, 1), (4, 2)]
LUT_CONSTANTS = ("kLutWarps", "kLutPass")


def depth(shape) -> int:
    return 8 * shape[1] * shape[2]


def tile_of(shape) -> tuple[int, int]:
    """(stage depth, columns) of an EU or output-transform shape."""
    return 8 * shape[2] * shape[3], 8 * shape[1]


def _patched(values: dict) -> str:
    src = (build.CSRC / "common.cuh").read_text()
    for name, value in values.items():
        src, n = re.subn(rf"(constexpr int {name} = )\d+;",
                         rf"\g<1>{value};", src)
        if n != 1:
            raise RuntimeError(f"{name} not found in common.cuh")
    return src


def compile_variants(variants: dict, sources: tuple) -> dict:
    """variants: key -> {constant: value}. Builds ``sources`` against each
    patched common.cuh at once; returns key -> the loaded library, its C
    entry points typed as in ``build.SIGNATURES``."""
    nvcc = build._nvcc()
    procs = []
    for key, values in variants.items():
        out = build.BUILD_DIR / "gru_tiles" / "_".join(
            str(v) for part in key for v in (part if isinstance(part, tuple)
                                             else (part,)))
        out.mkdir(parents=True, exist_ok=True)
        (out / "common.cuh").write_text(_patched(values))
        for name in sources:
            shutil.copy(build.CSRC / name, out)
        cmd = [nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(out / "lib.so"),
               *(str(out / name) for name in sources)]
        procs.append((key, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for key, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"shape {key}: registers {regs}, spill stores {spills}")
        lib = ctypes.CDLL(str(out / "lib.so"))
        for name, argtypes in build.SIGNATURES.items():
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        libs[key] = lib
    return libs


def compile_all() -> dict:
    """shape -> the rt_gru_cell entry point of its build."""
    libs = compile_variants({s: dict(zip(CONSTANTS, s)) for s in SHAPES},
                            ("gru_cell.cu",))
    return {s: lib.rt_gru_cell for s, lib in libs.items()}


def device_us(fn, reps: int = 20, iters: int = 20) -> float:
    """Device time per call: ``reps`` calls in one CUDA graph, replayed
    ``iters`` times between CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(iters):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) * 1e3 / (iters * reps)


def sweep_gru(device):
    fns = compile_all()
    rng = np.random.RandomState(0)

    def f32(*shape, scale=1.0):
        return torch.as_tensor((rng.randn(*shape) * scale).astype(
            np.float32), device=device)

    w_i, w_h = f32(F, 3 * M, scale=F ** -0.5), f32(M, 3 * M, scale=M ** -0.5)
    b_i, b_h = f32(3 * M), f32(3 * M)
    mail, s, extra = f32(R, F), f32(R, M), f32(R, 3 * M)
    want = ops.gru_cell_plain(mail, s, w_i, w_h, b_i, b_h, extra)
    out = torch.empty((R, M), device=device)
    calls = {}
    for shape, fn in fns.items():
        with mock.patch.object(ops, "GRU_DEPTH", depth(shape)):
            w_tc = ops.pack_gru_tc(w_i, w_h)

        def call(fn=fn, w_tc=w_tc, shape=shape):
            err = fn(mail.data_ptr(), s.data_ptr(), extra.data_ptr(),
                     w_tc.data_ptr(), b_i.data_ptr(), b_h.data_ptr(),
                     out.data_ptr(), R, F, M,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{shape}: CUDA error {err}")

        call()
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        if not torch.allclose(out, want, **TOL):
            raise RuntimeError(f"{shape}: max abs err {err} off tolerance")
        calls[shape] = call
    w_ih, w_hh = w_i.T.contiguous(), w_h.T.contiguous()
    print(f"card: {torch.cuda.get_device_name(0)}")
    for order in (SHAPES, SHAPES[::-1]):
        lib = device_us(lambda: torch.gru_cell(mail, s, w_ih, w_hh, b_i, b_h))
        print(f"torch.gru_cell: {lib} us")
        for shape in order:
            print(f"shape {shape}: rows {16 * shape[0]}, warps {shape[1]}, "
                  f"stage depth {depth(shape)}, stages {shape[3]}: "
                  f"{device_us(calls[shape])} us", flush=True)


# ---------------------------------------------------------------------------
# the EU and the output transform
# ---------------------------------------------------------------------------


def _eu_inputs(device):
    """Seeded inputs of sat_aggregate and fused_step at the main path's
    shapes (as chip_smoke's kernel phase makes them)."""
    rng = np.random.RandomState(0)
    K, E, D = main_path.K, main_path.E, main_path.WIDTH
    Fe = main_path.GRAPH["f_edge"]
    V = main_path.GRAPH["n_users"] + main_path.GRAPH["n_items"]
    NE = main_path.GRAPH["n_edges"]

    def t(x):
        return torch.as_tensor(np.asarray(x), device=device)

    def f32(*shape, scale=1.0):
        return t((rng.randn(*shape) * scale).astype(np.float32))

    bounds = t(np.sort(10 ** rng.uniform(0, 7, E - 1)).astype(np.float32))
    dt = t((10 ** rng.uniform(0, 7, R)).astype(np.float32))
    sel_dt = t((10 ** rng.uniform(0, 7, (R, K))).astype(np.float32))
    gru = dict(w_i=f32(F, 3 * M, scale=F ** -0.5),
               w_h=f32(M, 3 * M, scale=M ** -0.5), b_i=f32(3 * M),
               b_h=f32(3 * M))
    attn = dict(w_v=f32(M + Fe, D, scale=(M + Fe) ** -0.5), b_v=f32(D),
                w_out=f32(M + D, D, scale=(M + D) ** -0.5), b_out=f32(D))
    folded = [dict(boundaries=bounds, table=f32(E, w)) for w in (3 * M, D)]
    sat_args = (f32(R, K, M + Fe), sel_dt, f32(R, K), t(rng.rand(R, K) > 0.2))
    fused_args = (
        t(rng.randint(0, V, R).astype(np.int32)),
        t(rng.randint(0, V, (R, K)).astype(np.int32)),
        t(rng.randint(0, NE, (R, K)).astype(np.int32)),
        t(np.where(rng.rand(R, K) < 0.3, rng.randint(0, R, (R, K)),
                   -1).astype(np.int32)),
        dt, t(rng.rand(R) > 0.3), sel_dt, f32(R, K),
        t(rng.rand(R, K) > 0.2), f32(V, M), f32(V, F), f32(NE, Fe))

    def packs():
        sat = ops.pack_sat_params(attn["w_v"], attn["b_v"], bounds,
                                  folded[1]["table"])
        fused = ops.pack_fused_params(gru, attn, *folded, F, M, Fe)
        return sat, fused

    return sat_args, fused_args, packs


@contextlib.contextmanager
def _using(lib, eu, out):
    """The wrappers of ``ops`` on library ``lib``, packing at the tiles of
    EU shape ``eu`` and output-transform shape ``out``."""
    (eu_d, eu_c), (out_d, out_c) = tile_of(eu), tile_of(out)
    with mock.patch.object(build, "library", lambda: lib), \
            mock.patch.multiple(ops, EU_DEPTH=eu_d, EU_COLS=eu_c,
                                OUT_DEPTH=out_d, OUT_COLS=out_c):
        yield


def _blocks(shape, rows, k=None) -> int:
    """Blocks of a launch over ``rows`` rows (batch rows of k winners when
    k is given) and N = 100 columns."""
    per = shape[0] * (16 // k if k else 16)
    return -(-100 // (8 * shape[1])) * -(-rows // per)


def sweep_eu(device):
    committed_eu, committed_out = EU_SHAPES[0], OUT_SHAPES[0]
    keys = [("eu", s, committed_out) for s in EU_SHAPES] + [
        ("out", committed_eu, s) for s in OUT_SHAPES[1:]]

    def values(eu, out):
        return {**{f"kEu{n}": v for n, v in zip(TC_CONSTANTS, eu)},
                **{f"kOut{n}": v for n, v in zip(TC_CONSTANTS, out)}}

    libs = compile_variants({key: values(*key[1:]) for key in keys},
                            ("sat_aggregate.cu", "fused_step.cu"))
    sat_args, fused_args, packs = _eu_inputs(device)
    calls = {}
    for key in keys:
        _, eu, out = key
        with _using(libs[key], eu, out):
            sat_p, fused_p = packs()
            got = ops.sat_aggregate(*sat_args, sat_p)
            got_h, got_s = ops.fused_step(*fused_args, fused_p)
        want = ops.sat_aggregate_plain(*sat_args, sat_p["w_v"],
                                       sat_p["b_v"], sat_p["bounds"],
                                       sat_p["table"])
        want_h, want_s = ops.fused_step_plain(*fused_args, fused_p)
        for name, a, b in (("sat_aggregate", got, want),
                           ("fused_step h", got_h, want_h),
                           ("fused_step s_upd", got_s, want_s)):
            if not torch.allclose(a, b, **TOL):
                raise RuntimeError(f"{key} {name}: max abs err "
                                   f"{float((a - b).abs().max())} off "
                                   f"tolerance")

        def sat(key=key, sat_p=sat_p):
            with _using(libs[key], *key[1:]):
                ops.sat_aggregate(*sat_args, sat_p)

        def fused(key=key, fused_p=fused_p):
            with _using(libs[key], *key[1:]):
                ops.fused_step(*fused_args, fused_p)

        calls[key] = (sat, fused)
    print(f"card: {torch.cuda.get_device_name(0)}")
    for order in (keys, keys[::-1]):
        for key in order:
            kind, eu, out = key
            shape = eu if kind == "eu" else out
            d, c = tile_of(shape)
            blocks = (_blocks(eu, R, main_path.K) if kind == "eu"
                      else _blocks(out, R))
            sat, fused = calls[key]
            sat_us = f"sat_aggregate {device_us(sat)} us, " \
                if kind == "eu" else ""
            print(f"{kind} shape {shape}: rows {16 * shape[0]}, columns "
                  f"{c}, warps {shape[2]}, stage depth {d}, stages "
                  f"{shape[4]}, blocks {blocks}: {sat_us}fused_step "
                  f"{device_us(fused)} us", flush=True)


# ---------------------------------------------------------------------------
# lut_encode
# ---------------------------------------------------------------------------


def sweep_lut(device):
    libs = compile_variants({s: dict(zip(LUT_CONSTANTS, s))
                             for s in LUT_SHAPES}, ("lut_encode.cu",))
    rng = np.random.RandomState(0)
    E, D = main_path.E, 3 * M
    packed = ops.pack_lut_params(
        torch.as_tensor(np.sort(10 ** rng.uniform(0, 7, E - 1)).astype(
            np.float32), device=device),
        torch.as_tensor(rng.randn(E, D).astype(np.float32), device=device))
    dt = torch.as_tensor((10 ** rng.uniform(0, 7, R)).astype(np.float32),
                         device=device)
    want = ops.lut_encode_plain(dt, packed["bounds"], packed["table"])
    out = torch.empty((R, D), device=device)
    calls = {}
    for shape, lib in libs.items():
        def call(name, lib=lib, shape=shape):
            err = getattr(lib, name)(
                dt.data_ptr(), packed["bounds"].data_ptr(),
                packed["table"].data_ptr(), out.data_ptr(), R, E, D,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{shape}: CUDA error {err}")

        out.zero_()
        call("rt_lut_encode")
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise RuntimeError(f"{shape}: lut_encode differs from plain")
        calls[shape] = (lambda c=call: c("rt_lut_encode"),
                        lambda c=call: c("rt_noop"))
    print(f"card: {torch.cuda.get_device_name(0)}")
    for order in (LUT_SHAPES, LUT_SHAPES[::-1]):
        for shape in order:
            kern, floor = calls[shape]
            print(f"lut shape {shape}: rows a block {shape[0]}, copies "
                  f"before stores {shape[1]}, blocks {-(-R // shape[0])}: "
                  f"lut_encode {device_us(kern)} us, launch floor "
                  f"{device_us(floor)} us", flush=True)


def main():
    device = resolve_device()
    sweep_lut(device)
    sweep_gru(device)
    sweep_eu(device)


if __name__ == "__main__":
    main()
