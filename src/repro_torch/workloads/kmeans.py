"""Batched K-Means (Lloyd) with every divide routed through the division unit.

The PyTorch counterpart of ``src/repro/workloads/kmeans.py``. Lloyd's
algorithm divides at two sites per iteration, both through
:mod:`repro_torch.core.division_modes`:

  1. **Assignment distances** — mean squared distance ``||x - c||^2 / D``
     over the whole (N, K) plane.
  2. **Centroid update** — ``c_k = sum(x_i in k) / count_k``, (K, D) / (K, 1).
     Empty clusters keep their previous centroid.

The inertia (mean within-cluster squared distance) is divided through the
unit too. ``kmeans(x, k, cfg=EXACT)`` is the exact twin of any mode on the
same init. ``x`` of shape (..., N, D) clusters each batch member on its own.

:func:`kmeans_sharded` is the data-parallel run over the active mesh's
batch axes (the reference's shard_map body): each rank assigns its own
points, and the per-cluster counts and sums are reduced across the ranks
before the centroid divide.

Matrix products run in full f32: TF32 would keep ~10 mantissa bits and drown
the divider's error signature, so :func:`_full_f32_matmul` turns it off
around the einsums (it is off by default; the guard makes the choice
explicit and restores the caller's setting).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from repro_torch.core import division_modes as dm

__all__ = ["KMeansResult", "kmeans", "kmeans_sharded", "lloyd_step", "pairwise_sqdist",
           "pairwise_mean_sqdist", "make_blobs"]


@dataclasses.dataclass(frozen=True)
class KMeansResult:
    """Outcome of a Lloyd run.

    centroids:     (..., K, D) final centroids.
    assignments:   (..., N) int64 cluster index per point (final centroids).
    inertia:       (...,) mean min squared distance under the final centroids.
    inertia_trace: (n_iters, ...) inertia before each update step.
    """

    centroids: torch.Tensor
    assignments: torch.Tensor
    inertia: torch.Tensor
    inertia_trace: torch.Tensor


@contextlib.contextmanager
def _full_f32_matmul():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def pairwise_sqdist(x, c):
    """Squared distance plane ||x_n - c_k||^2, shape (..., N, K).

    Expanded as x.x - 2 x.c + c.c, built in place in the x.c buffer to keep
    one (N, K) plane alive.
    """
    x2 = (x * x).sum(-1)[..., :, None]
    c2 = (c * c).sum(-1)[..., None, :]
    with _full_f32_matmul():
        d2 = torch.einsum("...nd,...kd->...nk", x, c)
    return d2.mul_(-2.0).add_(x2).add_(c2).clamp_min_(0.0)   # (x2 - 2xc) + c2, >= 0


def pairwise_mean_sqdist(x, c, cfg: dm.DivisionConfig = dm.TAYLOR):
    """Mean squared distance plane ||x_n - c_k||^2 / D, shape (..., N, K).

    The 1/D normalizer goes through ``division_modes.div``.
    """
    return dm.div(pairwise_sqdist(x, c),
                  torch.tensor(x.shape[-1], dtype=x.dtype, device=x.device), cfg)


def _assign_and_inertia(x, c, cfg: dm.DivisionConfig, shards=None):
    """Assignment + mean inertia under fixed centroids (no update); with
    ``shards`` (a :class:`_Shards`), the inertia of every rank's points."""
    d2 = pairwise_mean_sqdist(x, c, cfg)
    dmin, assign = d2.min(-1)
    del d2
    total, n = dmin.sum(-1), x.shape[-2]
    if shards is not None:
        total, n = shards.total(total), shards.n_total
    inertia = dm.div(total, torch.tensor(n, dtype=x.dtype, device=x.device), cfg)
    return assign, inertia


# Canonical accumulation blocking of the (N, K) x (N, D) centroid sums: 8
# row-major block partials summed left to right, as the reference does.
_SUM_BLOCKS = 8


def _block_cluster_sums(onehot, x, n_blocks: int):
    """(n_blocks, K, D) per-cluster sums over row-major row blocks."""
    with _full_f32_matmul():
        return torch.stack([torch.einsum("nk,nd->kd", o, b)
                            for o, b in zip(onehot.chunk(n_blocks, 0), x.chunk(n_blocks, 0))])


def _ordered_block_sum(parts):
    """Left-to-right sum over the leading axis: one fixed reduction order."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _cluster_sums(onehot, x):
    """Per-cluster coordinate sums, (..., K, D), in the canonical order when
    x is (N, D) with N divisible by the block count."""
    if x.ndim == 2 and x.shape[0] % _SUM_BLOCKS == 0:
        return _ordered_block_sum(_block_cluster_sums(onehot, x, _SUM_BLOCKS))
    with _full_f32_matmul():
        return torch.einsum("...nk,...nd->...kd", onehot, x)


def lloyd_step(x, c, cfg: dm.DivisionConfig = dm.TAYLOR, shards=None):
    """One Lloyd iteration: assign, update centroids, measure inertia.

    Returns ``(new_centroids, assignments, inertia)``; the inertia is the
    one before the update (the objective the assignment minimized). With
    ``shards`` (a :class:`_Shards`), ``x`` is this rank's block of the
    points, and the counts, sums and inertia are every rank's.
    """
    k = c.shape[-2]
    assign, inertia = _assign_and_inertia(x, c, cfg, shards)
    onehot = _onehot(assign, k, x.dtype)                      # (..., N, K)
    counts = onehot.sum(-2)                                   # (..., K), exact
    if shards is None:
        sums = _cluster_sums(onehot, x)                       # (..., K, D)
    else:
        counts, sums = shards.total(counts), shards.cluster_sums(onehot, x)
    del onehot
    # Divide by max(count, 1) so no 0/0 lane exists; empty clusters keep
    # their previous centroid.
    occupied = counts[..., :, None] > 0
    new_c = dm.div(sums, counts.clamp_min(1.0)[..., :, None], cfg)
    new_c = torch.where(occupied, new_c, c)
    return new_c, assign, inertia


def _lloyd(x, c, cfg: dm.DivisionConfig, n_iters: int, shards=None):
    """``n_iters`` Lloyd iterations from ``c``, then the final assignment:
    (centroids, assignments, inertia, inertia trace)."""
    trace = []
    for _ in range(n_iters):
        c, _, inertia = lloyd_step(x, c, cfg, shards)
        trace.append(inertia)
    # Final assignment/inertia under the converged centroids.
    assign, inertia = _assign_and_inertia(x, c, cfg, shards)
    trace = (torch.stack(trace) if trace
             else torch.empty((0,) + inertia.shape, dtype=x.dtype, device=x.device))
    return c, assign, inertia, trace


def kmeans(x, k: Optional[int] = None, *, cfg: dm.DivisionConfig = dm.TAYLOR,
           n_iters: int = 10, init=None, generator: torch.Generator | None = None,
           device="cuda") -> KMeansResult:
    """Run ``n_iters`` Lloyd iterations of K-Means on ``x`` (..., N, D).

    ``x`` and ``init`` move to ``device`` (pass ``device="cpu"`` to run the
    plain versions on the CPU). ``init`` (..., K, D) pins the starting
    centroids; without it ``k`` distinct points are drawn with ``generator``
    (default: a CPU generator seeded with 0), shared across batch dims.
    """
    x = torch.as_tensor(x).to(device)
    if init is None:
        if k is None:
            raise ValueError("pass k or an explicit init")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        idx = torch.randperm(x.shape[-2], generator=generator)[:k]
        init = x.index_select(-2, idx.to(x.device))
    else:
        init = torch.as_tensor(init).to(device=x.device, dtype=x.dtype)
        if k is not None and k != init.shape[-2]:
            raise ValueError(f"k={k} != init.shape[-2]={init.shape[-2]}")
    c = init.expand(x.shape[:-2] + init.shape[-2:]).clone()
    c, assign, inertia, trace = _lloyd(x, c, cfg, n_iters)
    return KMeansResult(centroids=c, assignments=assign, inertia=inertia,
                        inertia_trace=trace)


def _onehot(assign, k: int, dtype):
    onehot = torch.zeros(assign.shape + (k,), dtype=dtype, device=assign.device)
    return onehot.scatter_(-1, assign[..., None], 1.0)


def kmeans_sharded(x, k: Optional[int] = None, *, cfg: dm.DivisionConfig = dm.TAYLOR,
                   n_iters: int = 10, init=None, generator: torch.Generator | None = None,
                   device="cuda") -> KMeansResult:
    """Data-parallel Lloyd over the active mesh: production-scale K-Means.

    ``x`` is (N, D): a DTensor whose dim 0 is split over the batch axes
    (the largest prefix of ('pod', 'data') that divides N,
    ``rules.batch_partition``), or the global points, the same on every
    rank, of which each rank takes its block. Centroids are replicated.
    Each iteration assigns the rank's own points, then reduces the
    per-cluster counts (exact: integers in f32) and sums across the ranks
    **before** the centroid divide, so the unit divides global operands and
    a cluster empty on one rank is not empty. When N % 8 == 0 and the rank
    count divides 8, each rank computes its whole blocks of the canonical 8
    block partials; the partials are gathered in rank order and summed left
    to right, as the unsharded run sums them, so the centroids come out as
    its bits wherever the block products do; otherwise the sums are
    all-reduced. The inertia is divided through the unit after its
    all-reduce (another summation order than the unsharded run's).

    Returns the replicated centroids, inertia and trace, and the
    assignments as a DTensor split like ``x``. The division sites run on
    plain blocks under ``rules.suspend_mesh()``. Without an active mesh, or
    when no batch-axis prefix divides N, this is :func:`kmeans`.
    """
    from repro_torch.sharding import comm
    from repro_torch.sharding import rules as shr

    if x.ndim != 2:
        raise ValueError(f"kmeans_sharded wants (N, D) points, got {tuple(x.shape)}")
    mesh = shr.active_mesh()
    n_total = x.shape[0]
    axes = shr.batch_partition(mesh, n_total) if mesh is not None else ()
    n_shards = shr.axes_size(mesh, axes) if axes else 1
    if n_shards <= 1:
        return kmeans(x, k, cfg=cfg, n_iters=n_iters, init=init, generator=generator,
                      device=device)
    sharding = shr.batch_sharding(mesh, axes, 2)
    xl = shr.batch_local(x, sharding).to(device)
    n_local = xl.shape[0]
    if init is None:
        if k is None:
            raise ValueError("pass k or an explicit init")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        # The same draw as kmeans(); each rank adds the rows it holds.
        idx = torch.randperm(n_total, generator=generator)[:k].to(xl.device)
        lo = shr.local_offset(sharding, 0, n_total)
        held = (idx >= lo) & (idx < lo + n_local)
        mine = torch.zeros((k, xl.shape[1]), dtype=xl.dtype, device=xl.device)
        mine[held] = xl[idx[held] - lo]
        init = comm.all_reduce(mine, mesh, axes)
    else:
        init = torch.as_tensor(init).to(device=xl.device, dtype=xl.dtype)
        if k is not None and k != init.shape[-2]:
            raise ValueError(f"k={k} != init.shape[-2]={init.shape[-2]}")
    shards = _Shards(mesh, axes, n_total, n_shards)
    with shr.suspend_mesh():
        c, assign, inertia, trace = _lloyd(xl, init.clone(), cfg, n_iters, shards)
    from torch.distributed.tensor import DTensor

    assignments = DTensor.from_local(assign, mesh, shr.batch_sharding(mesh, axes, 1).placements,
                                     run_check=False)
    return KMeansResult(centroids=c, assignments=assignments, inertia=inertia,
                        inertia_trace=trace)


@dataclasses.dataclass(frozen=True)
class _Shards:
    """How :func:`lloyd_step` reduces over the ranks along ``axes``: sums
    all-reduced; the centroid sums, when N % 8 == 0 and the rank count
    divides 8, as this rank's whole blocks of the canonical 8 partials,
    gathered in rank order and summed left to right."""
    mesh: object
    axes: tuple
    n_total: int
    n_shards: int

    def total(self, t):
        from repro_torch.sharding import comm

        return comm.all_reduce(t, self.mesh, self.axes)

    def cluster_sums(self, onehot, x):
        from repro_torch.sharding import comm

        if self.n_total % _SUM_BLOCKS == 0 and _SUM_BLOCKS % self.n_shards == 0:
            parts = _block_cluster_sums(onehot, x, _SUM_BLOCKS // self.n_shards)
            return _ordered_block_sum(comm.all_gather(parts, self.mesh, self.axes))
        with _full_f32_matmul():
            return self.total(torch.einsum("nk,nd->kd", onehot, x))


def make_blobs(generator: torch.Generator, n: int, d: int, k: int, *,
               spread: float = 0.15, dtype=torch.float32, device=None):
    """Gaussian blob mixture: (n, d) points around k centers in [-1, 1]^d.

    The draws come from ``generator`` on its own device, so a CUDA
    generator makes large sets on the card; the points stay there unless
    ``device`` names another.
    """
    gdev = generator.device
    centers = torch.rand((k, d), generator=generator, dtype=dtype,
                         device=gdev) * 2.0 - 1.0
    which = torch.randint(0, k, (n,), generator=generator, device=gdev)
    pts = torch.randn((n, d), generator=generator, dtype=dtype, device=gdev)
    pts.mul_(spread).add_(centers[which])
    return pts if device is None else pts.to(device)
