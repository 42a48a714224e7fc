"""Device time of the GRU update for other tile shapes of rt::gru_update.

    PYTHONPATH=src python -m repro_torch.launch.gru_tiles

For each shape in ``SHAPES`` (m16 row tiles a block, warps a block, k8
steps a warp per stage, cp.async ring stages) it compiles a copy of
``kernels/csrc/common.cuh`` with those constants, and ``gru_cell.cu``,
with nvcc into ``build/repro_torch/gru_tiles/``, all at once. Then, at
the main path's shapes (R = 400 rows, f_mail = 372, f_mem = 100, seeded
inputs), it packs the weights at each shape's stage depth, checks the
result against ``gru_cell_plain`` (rtol = atol = 1e-5) and prints the
device time per call from CUDA-graph replays, over two rounds (the shapes
in order, then reversed), beside ``torch.gru_cell``'s. Needs a CUDA
device and nvcc.
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from unittest import mock

import numpy as np
import torch

from repro_torch.kernels import build, ops
from repro_torch.utils import resolve_device

#: (kGruMTiles, kGruWarps, kGruKSteps, kGruStages); the first is the
#: committed shape.
SHAPES = [(1, 4, 2, 3), (1, 4, 2, 4), (1, 4, 1, 3), (1, 4, 4, 3),
          (1, 2, 2, 4), (1, 2, 4, 4), (1, 8, 1, 3), (1, 8, 1, 4),
          (2, 4, 1, 3), (2, 4, 2, 3), (2, 8, 1, 3), (2, 8, 1, 4),
          (1, 4, 2, 6), (2, 8, 1, 6)]
CONSTANTS = ("kGruMTiles", "kGruWarps", "kGruKSteps", "kGruStages")
R, F, M = 400, 372, 100


def depth(shape) -> int:
    return 8 * shape[1] * shape[2]


def compile_all() -> dict:
    """shape -> the rt_gru_cell entry point of its build."""
    nvcc = build._nvcc()
    procs = []
    for shape in SHAPES:
        out = build.BUILD_DIR / "gru_tiles" / "_".join(map(str, shape))
        out.mkdir(parents=True, exist_ok=True)
        src = (build.CSRC / "common.cuh").read_text()
        for name, value in zip(CONSTANTS, shape):
            src, n = re.subn(rf"(constexpr int {name} = )\d+;",
                             rf"\g<1>{value};", src)
            if n != 1:
                raise RuntimeError(f"{name} not found in common.cuh")
        (out / "common.cuh").write_text(src)
        shutil.copy(build.CSRC / "gru_cell.cu", out)
        cmd = [nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(out / "lib.so"),
               str(out / "gru_cell.cu")]
        procs.append((shape, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    fns = {}
    for shape, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {shape}:\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"shape {shape}: registers {regs}, spill stores {spills}")
        fn = ctypes.CDLL(str(out / "lib.so")).rt_gru_cell
        fn.argtypes = build.SIGNATURES["rt_gru_cell"]
        fn.restype = ctypes.c_int
        fns[shape] = fn
    return fns


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


def main():
    device = resolve_device()
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
        if not torch.allclose(out, want, rtol=1e-5, atol=1e-5):
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


if __name__ == "__main__":
    main()
