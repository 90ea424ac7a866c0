"""The split row softmax: launch wrappers, launch count and plain versions.

A row whose elements lie on several ranks (a decode cache split by
sequence, ``models.attention._split_sdpa``) is normalised in three passes
with the ranks' all-reduces between them: :func:`split_max` (the rank's row
maxima), :func:`split_exp` (``exp(x - top)`` with ``top`` the maxima over
the ranks, and its row sums in ``common.row_sum``'s order), and
:func:`split_scale` (``ex * (1/total)`` with ``total`` the sums over the
ranks, the reciprocal through the division unit's ``recip_f32_bits``; 0
where ``total`` is 0). On one rank the three give
``softmax.softmax_plain``'s bits: the same stages as the fused kernel that
replaces the reference's Pallas ``softmax_2d``
(``src/repro/kernels/softmax.py``), cut where the ranks combine.

The kernels are ``csrc/softmax.cu``'s ``softmax_split_max`` /
``softmax_split_exp`` / ``softmax_split_scale``; they take contiguous
``(M, D)`` f32 rows. Where rows are few the max and exp passes spread a row
over blocks that meet in a workspace (:func:`_workspace`), one a device
and stream. On CPU tensors
the wrappers run the plain versions;
on CUDA tensors they launch the kernel or raise; fake tensors take
:mod:`.fake`'s path. Each launch adds one to ``LAUNCHES``. No autograd:
decode runs without gradients.
"""
from __future__ import annotations

import torch

from repro_torch.core.seeds import SeedTable, compute_segments
from . import _build, common, fake
from .softmax import rows_on_card
from .tsdiv import SCHEDULES, _check, _check_schedule, _ptr, _stream, _table_c

__all__ = ["LAUNCHES", "reset_launches", "split_max_plain", "split_exp_plain",
           "split_scale_plain", "split_max", "split_exp", "split_scale"]

LAUNCHES = {"softmax_split_f32": 0}


def reset_launches() -> None:
    LAUNCHES["softmax_split_f32"] = 0


def split_max_plain(x: torch.Tensor) -> torch.Tensor:
    """The rows' maxima, (M, 1); nan where a row holds one."""
    return x.amax(-1, keepdim=True)


def split_exp_plain(x: torch.Tensor, top: torch.Tensor):
    """``exp(x - top)`` (a ``top`` that is not finite shifts by 0) and its
    row sums in ``common.row_sum``'s order: ((M, D), (M, 1))."""
    mfin = torch.where(torch.isfinite(top), top, 0.0)
    ex = torch.exp(x - mfin)
    return ex, common.row_sum(ex)


def split_scale_plain(ex: torch.Tensor, total: torch.Tensor, table: SeedTable, n_iters: int,
                      schedule: str) -> torch.Tensor:
    """``ex * recip_f32_bits(total)``, 0 where ``total`` is 0."""
    rs = common.recip_f32_bits(total, table, n_iters, schedule)
    return torch.where(total == 0.0, 0.0, ex * rs)


# The max and exp passes' workspace, one a device and stream: (M, 256) f32
# partials (a row's slab maxima or chain sums) and M u32 tickets, which the
# kernels leave at 0, so it is zeroed only when it grows, never per call.
# Launches on one stream run one after another, so no two launches use a
# buffer at once; launches on two streams take two buffers.
_WORKSPACE: dict = {}


def _workspace(x: torch.Tensor, stream: int):
    """(partials, tickets) for ``x``'s M rows on its device and the stream
    (its handle) the launch runs on. The tickets lie past every row of
    partials the buffer holds, so no launch writes a partial over a ticket."""
    chains = common.REDUCE_THREADS
    key = (x.device, stream)
    ws = _WORKSPACE.get(key)
    if ws is None or ws.numel() < x.shape[0] * (chains + 1):
        ws = _WORKSPACE[key] = torch.zeros(x.shape[0] * (chains + 1), dtype=torch.float32,
                                           device=x.device)
    rows = ws.numel() // (chains + 1)
    return ws[:rows * chains], ws[rows * chains:]


def _rows(*ts: torch.Tensor) -> bool:
    """On the card: f32 operands, (M, D) rows and (M, 1) columns."""
    on_card = rows_on_card(*ts)
    if on_card and any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"the split softmax takes float32, got {[t.dtype for t in ts]}")
    return on_card


def split_max(x: torch.Tensor) -> torch.Tensor:
    """The maxima of contiguous (M, D) f32 rows, (M, 1)."""
    if fake.is_fake(x):
        return fake.call("softmax_split_f32", x.new_empty((x.shape[0], 1)))
    if not _rows(x):
        return split_max_plain(x)
    out = x.new_empty((x.shape[0], 1))
    if x.numel():
        with torch.cuda.device(x.device):
            stream = _stream(x)
            part, ticket = _workspace(x, stream.value)
            rc = _build.library("softmax").softmax_split_max(
                _ptr(x), _ptr(out), _ptr(part), _ptr(ticket), x.shape[0], x.shape[1], stream)
        _check(rc, "softmax_split_f32")
        LAUNCHES["softmax_split_f32"] += 1
    return out


def split_exp(x: torch.Tensor, top: torch.Tensor):
    """``exp(x - top)`` of contiguous (M, D) f32 rows and its row sums:
    ((M, D), (M, 1)); ``top`` (M, 1), the maxima over the ranks."""
    top = top.reshape(-1, 1).contiguous()
    if fake.is_fake(x, top):
        return (fake.call("softmax_split_f32", torch.empty_like(x)),
                x.new_empty((x.shape[0], 1)))
    if not _rows(x, top):
        return split_exp_plain(x, top)
    ex, s = torch.empty_like(x), x.new_empty((x.shape[0], 1))
    if x.numel():
        with torch.cuda.device(x.device):
            stream = _stream(x)
            part, ticket = _workspace(x, stream.value)
            rc = _build.library("softmax").softmax_split_exp(
                _ptr(x), _ptr(top), _ptr(ex), _ptr(s), _ptr(part), _ptr(ticket), x.shape[0],
                x.shape[1], stream)
        _check(rc, "softmax_split_f32")
        LAUNCHES["softmax_split_f32"] += 1
    return ex, s


def split_scale(ex: torch.Tensor, total: torch.Tensor, n_iters: int = 2,
                precision_bits: int = 24, schedule: str = "factored") -> torch.Tensor:
    """``ex * (1/total)`` of contiguous (M, D) f32 rows, 0 where ``total``
    (M, 1), the sums over the ranks, is 0; the reciprocal through the
    division unit."""
    table = compute_segments(n_iters, precision_bits)
    total = total.reshape(-1, 1).contiguous()
    if fake.is_fake(ex, total):
        return fake.call("softmax_split_f32", torch.empty_like(ex))
    if not _rows(ex, total):
        return split_scale_plain(ex, total, table, n_iters, schedule)
    _check_schedule(schedule, n_iters)
    out = torch.empty_like(ex)
    if ex.numel():
        with torch.cuda.device(ex.device):
            rc = _build.library("softmax").softmax_split_scale(
                _ptr(ex), _ptr(total), _ptr(out), ex.shape[0], ex.shape[1], _table_c(table),
                n_iters, SCHEDULES[schedule], _stream(ex))
        _check(rc, "softmax_split_f32")
        LAUNCHES["softmax_split_f32"] += 1
    return out
