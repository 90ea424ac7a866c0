"""Launch wrappers of the fused division-unit kernels, with launch counts.

Each wrapper takes contiguous f32 tensors of one shape and returns a new
tensor. On a CPU tensor it runs the kernel's plain version
(:mod:`.common`); on a CUDA tensor it launches the CUDA kernel
(``csrc/tsdiv.cu``) on the current stream, or raises. There is no fallback
from the card to the plain version. Fake tensors (the dry run's trace) take
:mod:`.fake`'s path: an empty output, counted in ``fake.CALLS``.

``LAUNCHES`` counts kernel launches per kernel; a wrapper adds one where it
launches and nowhere else, so a run can show that its path went through
the kernels (``chip_smoke.py`` resets and reads it).
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.core.seeds import SeedTable, compute_segments, rsqrt_seed_table
from . import _build, common, fake

__all__ = ["LAUNCHES", "reset_launches", "recip", "divide", "rsqrt"]

LAUNCHES = {"tsdiv_recip": 0, "tsdiv_divide": 0, "tsdiv_rsqrt": 0}
SCHEDULES = {"paper": 0, "factored": 1, "goldschmidt": 2}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# id(table) -> (table, its ctypes copy): each table is converted once. The
# entry keeps the table alive, so its id is not reused while it is cached.
_TABLES_C: dict = {}


def _table_c(table: SeedTable) -> _build.SeedTableC:
    """The kernels' by-value seed table for ``table``, built on first use."""
    hit = _TABLES_C.get(id(table))
    if hit is not None:
        return hit[1]
    n_seg = table.n_segments
    if n_seg > _build.MAX_SEGMENTS:
        raise ValueError(f"seed table has {n_seg} segments; the kernel takes "
                         f"at most {_build.MAX_SEGMENTS}")
    t = _build.SeedTableC()
    t.slopes[:n_seg] = table.slopes.astype(np.float32).tolist()
    t.intercepts[:n_seg] = table.intercepts.astype(np.float32).tolist()
    # The slots past the table's own hold +inf: the kernels' binary search
    # runs over all of them (csrc/tsdiv_body.cuh seed_segment).
    t.inner[:] = (table.inner_boundaries.astype(np.float32).tolist()
                  + [math.inf] * (_build.MAX_SEGMENTS - n_seg))
    _TABLES_C[id(table)] = (table, t)
    return t


def _on_card(*ts: torch.Tensor) -> bool:
    """False for CPU tensors (plain version); True for CUDA tensors that the
    kernel takes; raises for anything else."""
    dev = ts[0].device
    for t in ts:
        if t.device != dev or t.shape != ts[0].shape:
            raise ValueError("operands must share one device and one shape")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"kernel takes contiguous float32, got {t.dtype}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise RuntimeError(f"no division-unit kernel for device {dev}")
    return True


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check_schedule(schedule: str, n_iters: int) -> None:
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}")
    if n_iters > _build.MAX_TERMS:
        raise ValueError(f"n_iters={n_iters} above the kernel's {_build.MAX_TERMS}")


def recip(x: torch.Tensor, n_iters: int = 2, precision_bits: int = 24,
          schedule: str = "factored") -> torch.Tensor:
    """1/x elementwise through the fused reciprocal (FTZ)."""
    table = compute_segments(n_iters, precision_bits)
    on_card = _on_card(x)
    if fake.is_fake(x):
        return fake.call("tsdiv_recip", torch.empty_like(x))
    if not on_card:
        return common.recip_f32_bits(x, table, n_iters, schedule)
    _check_schedule(schedule, n_iters)
    out = torch.empty_like(x)
    if x.numel():
        with torch.cuda.device(x.device):
            rc = _build.library().tsdiv_recip_f32(
                _ptr(x), _ptr(out), x.numel(), _table_c(table), n_iters,
                SCHEDULES[schedule], _stream(x))
        _check(rc, "tsdiv_recip")
        LAUNCHES["tsdiv_recip"] += 1
    return out


def divide(a: torch.Tensor, b: torch.Tensor, n_iters: int = 2,
           precision_bits: int = 24, schedule: str = "factored") -> torch.Tensor:
    """a/b elementwise through the fused exponent-separated divide (FTZ)."""
    table = compute_segments(n_iters, precision_bits)
    on_card = _on_card(a, b)
    if fake.is_fake(a, b):
        return fake.call("tsdiv_divide", torch.empty_like(a))
    if not on_card:
        return common.divide_f32_bits(a, b, table, n_iters, schedule)
    _check_schedule(schedule, n_iters)
    out = torch.empty_like(a)
    if a.numel():
        with torch.cuda.device(a.device):
            rc = _build.library().tsdiv_divide_f32(
                _ptr(a), _ptr(b), _ptr(out), a.numel(), _table_c(table),
                n_iters, SCHEDULES[schedule], _stream(a))
        _check(rc, "tsdiv_divide")
        LAUNCHES["tsdiv_divide"] += 1
    return out


def rsqrt(x: torch.Tensor, newton_iters: int = 2,
          n_segments: int = 16) -> torch.Tensor:
    """x^-1/2 elementwise through the fused full-edge rsqrt (FTZ)."""
    table = rsqrt_seed_table(n_segments)
    on_card = _on_card(x)
    if fake.is_fake(x):
        return fake.call("tsdiv_rsqrt", torch.empty_like(x))
    if not on_card:
        return common.rsqrt_f32_bits(x, table, newton_iters)
    out = torch.empty_like(x)
    if x.numel():
        with torch.cuda.device(x.device):
            rc = _build.library().tsdiv_rsqrt_f32(
                _ptr(x), _ptr(out), x.numel(), _table_c(table), newton_iters,
                _stream(x))
        _check(rc, "tsdiv_rsqrt")
        LAUNCHES["tsdiv_rsqrt"] += 1
    return out
