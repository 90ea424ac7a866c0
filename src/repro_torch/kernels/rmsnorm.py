"""Fused RMSNorm: launch wrapper, launch count and plain version.

The kernel (``csrc/rmsnorm.cu`` ``rmsnorm_rows``) replaces the reference's
Pallas kernel ``src/repro/kernels/rmsnorm.py`` ``rmsnorm_2d``:
``ss = sum(x*x) * (1/d)``, ``r = rsqrt_f32(ss + eps)`` (PWL seed +
compensated Newton), ``r = 0`` where ``ss + eps`` is inf and nan where it is
nan, and ``(x * r) * w`` in x's type. Like the reference's kernel (and
unlike its ``rmsnorm_ref``) it multiplies by the f32 constant ``1/d``, with
``ss*(1/d) + eps`` fused as the compiled reference fuses it. It takes
contiguous ``(M, D)`` f32 or bf16 rows of any length and a contiguous
``(D,)`` f32 or bf16 weight, which the kernel reads in its own type (the
upcast to f32 is exact, so nothing is cast on the host); rows are not
padded, so ``d`` is the row's own length.

On a CPU tensor the wrapper runs :func:`rmsnorm_plain`; on a CUDA tensor it
launches the kernel or raises; fake tensors take :mod:`.fake`'s path.
``LAUNCHES`` counts launches, as in :mod:`.tsdiv`.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.seeds import SeedTable, rsqrt_seed_table
from . import _build, common, fake
from .softmax import DTYPES, rows_on_card
from .tsdiv import _check, _ptr, _stream, _table_c

__all__ = ["LAUNCHES", "reset_launches", "rmsnorm_plain", "takes_weight", "rmsnorm"]

LAUNCHES = {"rmsnorm_f32": 0}


def reset_launches() -> None:
    LAUNCHES["rmsnorm_f32"] = 0


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, eps: float,
                  table: SeedTable, newton_iters: int) -> torch.Tensor:
    """The kernel's arithmetic in torch ops, the sum in its order."""
    xf = x.to(torch.float32)
    ss = common.row_sum(xf * xf)
    se = common.fma(ss, float(np.float32(1.0 / x.shape[-1])), eps)
    r = common.rsqrt_f32(se, table, newton_iters)
    r = torch.where(torch.isinf(se), 0.0, r)
    r = torch.where(torch.isnan(se), torch.nan, r)
    return ((xf * r) * w.to(torch.float32)).to(x.dtype)


def takes_weight(w: torch.Tensor) -> bool:
    """Whether the kernel reads ``w`` as it is: a contiguous f32/bf16 tensor."""
    return w.dtype in DTYPES and w.is_contiguous()


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            newton_iters: int = 2, n_segments: int = 16) -> torch.Tensor:
    """RMSNorm over the last axis of contiguous (M, D) f32/bf16 rows."""
    table = rsqrt_seed_table(n_segments)
    if w.shape != x.shape[-1:]:
        raise ValueError(f"weight {tuple(w.shape)} does not match rows of "
                         f"{x.shape[-1]}")
    on_card = rows_on_card(x, w)
    if fake.is_fake(x, w):
        return fake.call("rmsnorm_f32", torch.empty_like(x))
    if not on_card:
        return rmsnorm_plain(x, w, eps, table, newton_iters)
    if not takes_weight(w):
        raise TypeError(f"the RMSNorm kernel takes a contiguous float32/bfloat16 "
                        f"weight, got {w.dtype}")
    out = torch.empty_like(x)
    if x.numel():
        with torch.cuda.device(x.device):
            rc = _build.library("rmsnorm").rmsnorm_rows(
                _ptr(x), _ptr(w), _ptr(out), x.shape[0], x.shape[1],
                DTYPES[x.dtype], DTYPES[w.dtype], ctypes.c_float(1.0 / x.shape[1]),
                ctypes.c_float(eps), _table_c(table), newton_iters, _stream(x))
        _check(rc, "rmsnorm_f32")
        LAUNCHES["rmsnorm_f32"] += 1
    return out
