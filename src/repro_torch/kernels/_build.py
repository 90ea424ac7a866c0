"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each ``csrc/*.cu`` source is compiled at first use, on the machine with the
card, into its own library in ``build/repro_torch_kernels/`` at the
repository root (listed in ``.gitignore``). A library is named by a hash of
its source, the shared headers and the flags, so an edit rebuilds and a
stale library is never loaded. :func:`build_all` starts one ``nvcc`` per
missing library, all at once. Nothing is compiled when this module is
imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SeedTableC", "library", "build_all", "BUILD_DIR", "build_info"]

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
LIBRARIES = ("tsdiv", "softmax", "rmsnorm", "flash_attention", "flash_attention_tc",
             "ilm")  # csrc/<name>.cu
HEADERS = ("tsdiv_body.cuh", "rows.cuh", "launch.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
MAX_SEGMENTS = 32   # TSDIV_MAX_SEGMENTS in csrc/tsdiv_body.cuh
MAX_TERMS = 16      # TSDIV_MAX_TERMS


class SeedTableC(ctypes.Structure):
    """ctypes mirror of ``struct TsdivSeedTable`` (passed by value)."""

    _fields_ = [("slopes", ctypes.c_float * MAX_SEGMENTS),
                ("intercepts", ctypes.c_float * MAX_SEGMENTS),
                ("inner", ctypes.c_float * (MAX_SEGMENTS - 1))]


_vp, _i64, _i32, _f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
# The C entry points of each library: name -> argument types (all return int).
_SIGNATURES = {
    "tsdiv": {
        "tsdiv_recip_f32": [_vp, _vp, _i64, SeedTableC, _i32, _i32, _vp],
        "tsdiv_divide_f32": [_vp, _vp, _vp, _i64, SeedTableC, _i32, _i32, _vp],
        "tsdiv_rsqrt_f32": [_vp, _vp, _i64, SeedTableC, _i32, _vp],
    },
    "softmax": {
        "softmax_rows": [_vp, _vp, _i64, _i32, _i32, SeedTableC, _i32, _i32, _vp],
        "softmax_split_max": [_vp, _vp, _vp, _vp, _i64, _i32, _vp],
        "softmax_split_exp": [_vp, _vp, _vp, _vp, _vp, _vp, _i64, _i32, _vp],
        "softmax_split_scale": [_vp, _vp, _vp, _i64, _i32, SeedTableC, _i32, _i32, _vp],
    },
    "rmsnorm": {
        "rmsnorm_rows": [_vp, _vp, _vp, _i64, _i32, _i32, _i32, _f32, _f32, SeedTableC,
                         _i32, _vp],
    },
    "flash_attention": {
        "flash_attention_f32": [_vp, _vp, _vp, _vp, _i64, _i32, _i32, _i32, _i32, _i32,
                                _i32, _i32, _f32, SeedTableC, _i32, _i32, _vp],
        "flash_attention_f32_blocks_per_sm": [_i32, ctypes.POINTER(ctypes.c_int)],
    },
    "flash_attention_tc": {
        "flash_attention_bf16": [_vp, _vp, _vp, _vp, _i64, _i32, _i32, _i32, _i32, _i32,
                                 _i32, _i32, _f32, SeedTableC, _i32, _i32, _vp],
        "flash_attention_bf16_blocks_per_sm": [_i32, _i32, ctypes.POINTER(ctypes.c_int)],
    },
    "ilm": {
        "ilm_mul_u32": [_vp, _vp, _vp, _i64, _i32, _vp],
        "ilm_square_u32": [_vp, _vp, _i64, _i32, _vp],
    },
}

_libs: dict = {}
build_info: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                           "CUDA toolkit on the machine with the card")
    return path


def _so_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in (f"{name}.cu", *HEADERS):
        digest.update((CSRC / src).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_all(names=LIBRARIES) -> None:
    """Compile every missing library, one nvcc process per source, in parallel."""
    todo = [(n, _so_path(n)) for n in names if not _so_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name, so in todo:
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        procs.append((name, so, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu: nvcc failed ({proc.returncode}):\n{err}")
            continue
        os.replace(tmp, so)
        build_info.setdefault("log", {})[name] = err
    build_info["seconds"] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))


def library(name: str = "tsdiv") -> ctypes.CDLL:
    """The loaded kernel library ``name``, building it first if needed."""
    if name in _libs:
        return _libs[name]
    so = _so_path(name)
    if not so.exists():
        build_all((name,))
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    build_info.setdefault("libraries", {})[name] = str(so)
    _libs[name] = lib
    return lib
