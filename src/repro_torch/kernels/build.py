"""Build and load the port's CUDA kernels (``kernels/csrc``).

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``. Each
``.cu`` file compiles in its own ``nvcc`` process, all started together,
then one link. The library lands in ``build/repro_torch/`` at the root of
the checkout, named by a hash of the sources and flags, so an unchanged
tree reuses it. A missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              *ARCH_FLAGS)

_P, _I = ctypes.c_void_p, ctypes.c_int

#: argtypes of every C entry point (pointers and the stream as void*).
SIGNATURES = {
    "rt_lut_encode": [_P] * 4 + [_I] * 3 + [_P],
    "rt_noop": [_P] * 4 + [_I] * 3 + [_P],
    "rt_gru_cell": [_P] * 7 + [_I] * 3 + [_P],
    "rt_sat_aggregate": [_P] * 9 + [_I] * 5 + [_P],
    "rt_fused_step": [_P] * 26 + [_I] * 8 + [_P],
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from kernels/csrc at first use and need "
                           "the CUDA toolkit")
    return nvcc


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources if this tree's library is not built yet; returns
    its path. The compiler's report (registers, spills) is kept beside it
    as ``build.log``."""
    lib = BUILD_DIR / f"librepro_torch_{source_digest()}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for obj, proc in procs:
            out, _ = proc.communicate()
            log.append(out)
            if proc.returncode != 0:
                failed.append(obj.stem)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *(str(o) for o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        (BUILD_DIR / "build.log").write_text("\n".join(log) + link.stdout)
        os.replace(tmp_lib, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
