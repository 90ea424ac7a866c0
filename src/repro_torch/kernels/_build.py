"""Build and load the CUDA division-unit kernels (nvcc + ctypes).

The sources in ``csrc/`` are compiled at first use, on the machine with the
card, into ``build/repro_torch_kernels/`` at the repository root (listed in
``.gitignore``). The library is named by a hash of its sources, so an edit
rebuilds and a stale library is never loaded. Nothing is compiled when this
module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SeedTableC", "library", "BUILD_DIR", "build_info"]

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("tsdiv.cu", "tsdiv_body.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
MAX_SEGMENTS = 32   # TSDIV_MAX_SEGMENTS in csrc/tsdiv_body.cuh
MAX_TERMS = 16      # TSDIV_MAX_TERMS


class SeedTableC(ctypes.Structure):
    """ctypes mirror of ``struct TsdivSeedTable`` (passed by value)."""

    _fields_ = [("n_inner", ctypes.c_int),
                ("slopes", ctypes.c_float * MAX_SEGMENTS),
                ("intercepts", ctypes.c_float * MAX_SEGMENTS),
                ("inner", ctypes.c_float * (MAX_SEGMENTS - 1))]


_lib = None
build_info: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                           "CUDA toolkit on the machine with the card")
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"libtsdiv_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(CSRC / "tsdiv.cu")],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
        build_info.update(seconds=time.perf_counter() - t0, log=proc.stderr)
    lib = ctypes.CDLL(str(so))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.tsdiv_recip_f32.argtypes = [vp, vp, i64, SeedTableC, i32, i32, vp]
    lib.tsdiv_divide_f32.argtypes = [vp, vp, vp, i64, SeedTableC, i32, i32, vp]
    lib.tsdiv_rsqrt_f32.argtypes = [vp, vp, i64, SeedTableC, i32, vp]
    for fn in (lib.tsdiv_recip_f32, lib.tsdiv_divide_f32, lib.tsdiv_rsqrt_f32):
        fn.restype = ctypes.c_int
    build_info["library"] = str(so)
    _lib = lib
    return lib
