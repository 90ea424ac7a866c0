"""Fused row softmax: launch wrapper, launch count and plain version.

The kernel (``csrc/softmax.cu`` ``softmax_rows``) replaces the reference's
Pallas kernel ``src/repro/kernels/softmax.py`` ``softmax_2d``: row max,
``exp(x - max)``, the row sum, and ``1/sum`` through the division unit's
``recip_f32_bits``; rows whose max is not finite shift by 0, and a row whose
sum is 0 (every logit -inf) comes out as zeros. It takes contiguous
``(M, D)`` f32 or bf16 rows of any length and returns the same type. A row
runs on one warp (on eight where rows are few, as in a decode step), and
its sum follows ``common.row_sum``'s order, which :func:`softmax_plain`
repeats.

On a CPU tensor the wrapper runs :func:`softmax_plain`; on a CUDA tensor it
launches the kernel or raises; fake tensors take :mod:`.fake`'s path.
``LAUNCHES`` counts launches, as in :mod:`.tsdiv`.
"""
from __future__ import annotations

import torch

from repro_torch.core.seeds import SeedTable, compute_segments
from . import _build, common, fake
from .tsdiv import SCHEDULES, _check, _check_schedule, _ptr, _stream, _table_c

__all__ = ["LAUNCHES", "reset_launches", "softmax_plain", "softmax",
           "rows_on_card", "DTYPES"]

LAUNCHES = {"softmax_f32": 0}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    LAUNCHES["softmax_f32"] = 0


def rows_on_card(*ts: torch.Tensor) -> bool:
    """False for CPU tensors (plain version); True for CUDA tensors that a
    row kernel takes (contiguous, f32 or bf16); raises for anything else."""
    for t in ts:
        if t.device != ts[0].device:
            raise ValueError("operands must share one device")
    if ts[0].device.type == "cpu":
        return False
    if ts[0].device.type != "cuda":
        raise RuntimeError(f"no row kernel for device {ts[0].device}")
    x = ts[0]
    if x.dtype not in DTYPES or x.dim() != 2 or not x.is_contiguous():
        raise TypeError(f"row kernels take contiguous 2-D float32/bfloat16, "
                        f"got {x.dtype} {tuple(x.shape)}")
    return True


def softmax_plain(x: torch.Tensor, table: SeedTable, n_iters: int,
                  schedule: str) -> torch.Tensor:
    """The kernel's arithmetic in torch ops, the sum in its order."""
    xf = x.to(torch.float32)
    m = xf.amax(-1, keepdim=True)
    mfin = torch.where(torch.isfinite(m), m, 0.0)
    ex = torch.exp(xf - mfin)
    s = common.row_sum(ex)
    rs = common.recip_f32_bits(s, table, n_iters, schedule)
    return torch.where(s == 0.0, 0.0, ex * rs).to(x.dtype)


def softmax(x: torch.Tensor, n_iters: int = 2, precision_bits: int = 24,
            schedule: str = "factored") -> torch.Tensor:
    """Softmax over the last axis of contiguous (M, D) f32/bf16 rows."""
    table = compute_segments(n_iters, precision_bits)
    on_card = rows_on_card(x)
    if fake.is_fake(x):
        return fake.call("softmax_f32", torch.empty_like(x))
    if not on_card:
        return softmax_plain(x, table, n_iters, schedule)
    _check_schedule(schedule, n_iters)
    out = torch.empty_like(x)
    if x.numel():
        with torch.cuda.device(x.device):
            rc = _build.library("softmax").softmax_rows(
                _ptr(x), _ptr(out), x.shape[0], x.shape[1], DTYPES[x.dtype],
                _table_c(table), n_iters, SCHEDULES[schedule], _stream(x))
        _check(rc, "softmax_f32")
        LAUNCHES["softmax_f32"] += 1
    return out
