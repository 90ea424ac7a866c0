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

__all__ = ["KMeansResult", "kmeans", "lloyd_step", "pairwise_sqdist",
           "pairwise_mean_sqdist",
           "make_blobs"]


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


def _assign_and_inertia(x, c, cfg: dm.DivisionConfig):
    """Assignment + mean inertia under fixed centroids (no update)."""
    d2 = pairwise_mean_sqdist(x, c, cfg)
    dmin, assign = d2.min(-1)
    del d2
    n_pts = torch.tensor(x.shape[-2], dtype=x.dtype, device=x.device)
    inertia = dm.div(dmin.sum(-1), n_pts, cfg)
    return assign, inertia


# Canonical accumulation blocking of the (N, K) x (N, D) centroid sums: 8
# row-major block partials summed left to right, as the reference does.
_SUM_BLOCKS = 8


def _cluster_sums(onehot, x):
    """Per-cluster coordinate sums, (..., K, D), in the canonical order when
    x is (N, D) with N divisible by the block count."""
    with _full_f32_matmul():
        if x.ndim == 2 and x.shape[0] % _SUM_BLOCKS == 0:
            parts = [torch.einsum("nk,nd->kd", o, b)
                     for o, b in zip(onehot.chunk(_SUM_BLOCKS, 0),
                                     x.chunk(_SUM_BLOCKS, 0))]
            out = parts[0]
            for p in parts[1:]:
                out = out + p
            return out
        return torch.einsum("...nk,...nd->...kd", onehot, x)


def lloyd_step(x, c, cfg: dm.DivisionConfig = dm.TAYLOR):
    """One Lloyd iteration: assign, update centroids, measure inertia.

    Returns ``(new_centroids, assignments, inertia)``; the inertia is the
    one before the update (the objective the assignment minimized).
    """
    k = c.shape[-2]
    assign, inertia = _assign_and_inertia(x, c, cfg)
    onehot = torch.zeros(assign.shape + (k,), dtype=x.dtype, device=x.device)
    onehot.scatter_(-1, assign[..., None], 1.0)               # (..., N, K)
    counts = onehot.sum(-2)                                   # (..., K), exact
    sums = _cluster_sums(onehot, x)                           # (..., K, D)
    del onehot
    # Divide by max(count, 1) so no 0/0 lane exists; empty clusters keep
    # their previous centroid.
    occupied = counts[..., :, None] > 0
    new_c = dm.div(sums, counts.clamp_min(1.0)[..., :, None], cfg)
    new_c = torch.where(occupied, new_c, c)
    return new_c, assign, inertia


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
    trace = []
    for _ in range(n_iters):
        c, _, inertia = lloyd_step(x, c, cfg)
        trace.append(inertia)
    # Final assignment/inertia under the converged centroids.
    assign, inertia = _assign_and_inertia(x, c, cfg)
    empty = torch.empty((0,) + inertia.shape, dtype=x.dtype, device=x.device)
    return KMeansResult(centroids=c, assignments=assign, inertia=inertia,
                        inertia_trace=torch.stack(trace) if trace else empty)


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
