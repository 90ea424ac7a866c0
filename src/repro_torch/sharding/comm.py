"""The collectives of the sharded paths, over a mesh's axes.

Each moves its operand through a CPU copy and the gloo process group of
each mesh axis in turn, and returns the result on the operand's device:
the same code runs on the CPU tests' gloo ranks and on ranks that share one
card (gloo carries CUDA tensors only through host copies of its own, and
NCCL takes one GPU per rank). The operands are small (counts, block
partials, scalars) except the train step's gradients and the FSDP leaves.
A split dim is moved first on the operand's device, before the host copy,
so the host only copies contiguous blocks. :func:`all_gather` is gloo's
all-to-all of the rank's block repeated once for each rank: gloo's own
all-gather moves a large block several times slower
(``tools/gloo_rates.py``).

Reductions over several axes run one axis after another, in the order
given; every rank ends with the same bits. :func:`all_gather` concatenates
the ranks' blocks in mesh order, the first axis major (pod-major over
('pod', 'data'), as JAX orders a dim split over both).

The tensor-parallel blocks over the ``model`` axis use two conjugate
operators that autograd differentiates (Megatron-LM's f and g):
:func:`copy_to_split` (identity forward, sum of the gradients backward) at
the input of a column-split product, whose ranks each see part of the
input's gradient, and :func:`reduce_from_split` (sum forward, identity
backward) at the output of a row-split product, whose ranks each hold a
partial sum. :func:`all_reduce_sum_grad` sums both ways: right for a value
that every rank's loss reads in full (MoE's aux), wrong for these two, where
it would scale the gradients by the number of ranks.

A leaf stored as the rank's block over a batch axis (FSDP: jamba's
``embed`` on ``data``) is put together before use by
:func:`gather_from_split`: an all-gather of the blocks, whose backward is
the reduce-scatter of the whole leaf's gradient in its dtype (as GSPMD
reduce-scatters it), so every rank's block of the gradient holds every
rank's tokens.

The expert exchange of the MoE FFN (``models/moe.py``) uses two more, each
differentiated: :func:`exchange` (an all-to-all over one axis: block j of
a dim goes to rank j; its backward is the same all-to-all of the
gradients) and :func:`gather_blocks` (an all-gather whose backward is the
reduce-scatter of the gradients: summed over the ranks, sliced to the
rank's block).

:func:`record` lists the collectives issued inside a block, one entry per
collective over one axis: the op, the bytes of its result and the ranks
of its group.
``launch/roofline.py`` ``tally_collectives`` turns the list into wire
bytes, as the reference's roofline parses its HLO's collectives.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch

from .rules import mesh_shape

__all__ = ["all_reduce", "all_gather", "all_to_all", "reduce_scatter", "all_reduce_sum_grad",
           "copy_to_split", "reduce_from_split", "exchange", "gather_blocks",
           "gather_from_split", "record"]

_RECORD: Optional[List[dict]] = None


@contextlib.contextmanager
def record():
    """Yields a list that receives ``{"op", "bytes", "ranks"}`` for each
    collective issued in the block (``op`` as HLO names it: ``all-reduce``,
    ``all-gather``, ``all-to-all``, ``reduce-scatter``; ``bytes`` of the
    whole operand the ranks exchange -- the result, except for a
    reduce-scatter, whose result is one block of it; ``ranks`` of the group,
    global ranks in order)."""
    global _RECORD
    prev, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = prev


def _note(op: str, whole: torch.Tensor, group) -> None:
    if _RECORD is not None:
        import torch.distributed as dist

        _RECORD.append({"op": op, "bytes": whole.numel() * whole.element_size(),
                        "ranks": list(dist.get_process_group_ranks(group))})


def _host(t: torch.Tensor, dim: int) -> torch.Tensor:
    """A CPU copy of ``t`` with ``dim`` moved first, contiguous: the
    transpose is made on ``t``'s device, the host copies the result."""
    return t.detach().movedim(dim, 0).contiguous().to("cpu", copy=True)


def _live(mesh, axes: Sequence[str]):
    sizes = mesh_shape(mesh)
    return [ax for ax in axes if sizes[ax] > 1]


def all_reduce(t: torch.Tensor, mesh, axes: Sequence[str], op: str = "sum") -> torch.Tensor:
    """``t`` reduced (``sum``, ``max`` or ``min``) over the ranks along
    ``axes``; ``t`` itself when they hold one rank."""
    import torch.distributed as dist

    live = _live(mesh, axes)
    if not live:
        return t
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op]
    buf = t.detach().to("cpu", copy=True).contiguous()
    for ax in live:
        dist.all_reduce(buf, op=red, group=mesh.get_group(ax))
        _note("all-reduce", buf, mesh.get_group(ax))
    return buf.to(t.device)


def all_gather(t: torch.Tensor, mesh, axes: Sequence[str], dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` along ``axes``, concatenated on ``dim`` in mesh
    order (the first axis major)."""
    import torch.distributed as dist

    buf = _host(t, dim)
    for ax in reversed(_live(mesh, axes)):
        group = mesh.get_group(ax)
        n = dist.get_world_size(group)
        out = torch.empty((n * buf.shape[0], *buf.shape[1:]), dtype=buf.dtype)
        dist.all_to_all_single(out, buf.repeat((n,) + (1,) * (buf.dim() - 1)), group=group)
        buf = out
        _note("all-gather", buf, group)
    return buf.movedim(0, dim).to(t.device)


def all_to_all(t: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """``t``'s ``dim`` cut into as many equal blocks as ``axis`` has ranks:
    block j goes to rank j, and the result holds at block i what rank i
    sent this rank. ``t`` itself on an axis of one rank."""
    import torch.distributed as dist

    if not _live(mesh, (axis,)):
        return t
    group = mesh.get_group(axis)
    buf = _host(t, dim)
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=group)
    _note("all-to-all", out, group)
    return out.movedim(0, dim).to(t.device)


def reduce_scatter(t: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The sum of the ranks' ``t`` along ``axis``, of which this rank keeps
    its block of ``dim`` (cut into as many equal blocks as the axis has
    ranks, in rank order)."""
    import torch.distributed as dist

    if not _live(mesh, (axis,)):
        return t
    group = mesh.get_group(axis)
    buf = _host(t, dim)
    out = torch.empty((buf.shape[0] // dist.get_world_size(group), *buf.shape[1:]),
                      dtype=buf.dtype)
    # reduce_scatter_single is the newer name of reduce_scatter_tensor.
    (getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor)(
        out, buf, group=group)
    _note("reduce-scatter", buf, group)
    return out.movedim(0, dim).to(t.device)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(t, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        # Each rank's loss reads the sum, so the input's gradient is the sum
        # of every rank's output gradient.
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


def all_reduce_sum_grad(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """:func:`all_reduce` (sum) that autograd differentiates: the backward
    pass sums the output's gradient over the same ranks."""
    return _AllReduceSum.apply(t, mesh, tuple(axes))


class _CopyToSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        # Each rank's split product saw its own columns: the input's
        # gradient is the sum of the ranks' parts.
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


class _ReduceFromSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        return all_reduce(t, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        # Every rank reads the whole sum with the same gradient, and each
        # partial sum enters it once.
        return g, None, None


def copy_to_split(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """``t`` unchanged; the backward pass sums its gradient over the ranks
    along ``axes`` (the input of a column-split product)."""
    if not _live(mesh, axes):
        return t
    return _CopyToSplit.apply(t, mesh, tuple(axes))


def reduce_from_split(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """The sum of the ranks' ``t`` along ``axes``, in ``t``'s dtype; the
    backward pass hands the gradient on unchanged (the output of a
    row-split product)."""
    if not _live(mesh, axes):
        return t
    return _ReduceFromSplit.apply(t, mesh, tuple(axes))


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_to_all(t, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        # Block i of the output came from rank i's block j: its gradient
        # goes back the same way.
        return all_to_all(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(t, mesh, (axis,), dim)

    @staticmethod
    def backward(ctx, g):
        # Every rank read the gathered tensor: a block's gradient is the sum
        # of the ranks' gradients of it.
        return reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _GatherFromSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(t, mesh, (axis,), dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        # Every rank's loss read the whole leaf: its block's gradient is the
        # sum of the ranks' gradients of that block.
        return reduce_scatter(g.contiguous(), ctx.mesh, ctx.axis, ctx.dim), None, None, None


def exchange(t: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """:func:`all_to_all` that autograd differentiates: the backward pass is
    the all-to-all of the output's gradient."""
    if not _live(mesh, (axis,)):
        return t
    return _Exchange.apply(t, mesh, axis, dim)


def gather_blocks(t: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """:func:`all_gather` over one axis that autograd differentiates: the
    backward pass is the :func:`reduce_scatter` of the output's gradient."""
    if not _live(mesh, (axis,)):
        return t
    return _GatherBlocks.apply(t, mesh, axis, dim)


def gather_from_split(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The whole leaf from this rank's block ``t`` of its ``dim`` over
    ``axis`` (an all-gather, contiguous); the backward pass reduce-scatters
    the whole leaf's gradient back to the block (FSDP)."""
    if not _live(mesh, (axis,)):
        return t
    return _GatherFromSplit.apply(t, mesh, axis, dim)
