"""QR decomposition via Givens rotations on the division unit.

The PyTorch counterpart of ``src/repro/workloads/qr.py``. Zeroing entry
(i, j) needs the rotation coefficients

    r = sqrt(a^2 + b^2),   c = a / r,   s = b / r

with a = R[j, j], b = R[i, j], computed through
:mod:`repro_torch.core.division_modes` in one of two ways:

  * ``via="div"``   — r by square root, then two divides;
  * ``via="rsqrt"`` — one rsqrt of a^2 + b^2, then two multiplies.

The rotation sequence is data-independent (column-major, top-down). Every
rotation is applied to a whole batch of matrices at once, so each division
site is one launch over the batch. Unlike the reference's functional
updates, the rows of R and Q^T are updated in place.
:func:`qr_givens_sharded` splits the batch over the active mesh.
"""
from __future__ import annotations

import torch

from repro_torch.core import division_modes as dm

__all__ = ["givens_operands", "givens_coeffs", "qr_givens", "qr_givens_batched",
           "qr_givens_sharded"]


def givens_operands(a, b):
    """``(an, bn, t, nonzero)``: a and b pre-scaled by one exact power of
    two, so that t = an^2 + bn^2 never under/overflows while a and b are
    normal, and the mask of lanes where (a, b) != (0, 0)."""
    m = torch.maximum(a.abs(), b.abs())
    e = torch.floor(torch.log2(torch.where(m > 0, m, 1.0))).clamp(-126.0, 126.0)
    inv = torch.exp2(-e).to(a.dtype)
    an, bn = a * inv, b * inv
    return an, bn, an * an + bn * bn, m > 0   # t in [1, 8) where nonzero


def givens_coeffs(a, b, cfg: dm.DivisionConfig = dm.TAYLOR, via: str = "div"):
    """Rotation coefficients (c, s) zeroing b against a; c^2 + s^2 = 1.

    (a, b) = (0, 0) gives the identity rotation (1, 0), masking the
    divider's edge lanes.
    """
    an, bn, t, safe = givens_operands(a, b)
    if via == "rsqrt":
        inv_r = dm.rsqrt(t, cfg)
        c, s = an * inv_r, bn * inv_r
    elif via == "div":
        r = torch.sqrt(t)
        c, s = dm.div(an, r, cfg), dm.div(bn, r, cfg)
    else:
        raise ValueError(f"via must be 'div' or 'rsqrt', got {via!r}")
    return torch.where(safe, c, 1.0), torch.where(safe, s, 0.0)


def _rotate_rows(mat, j: int, i: int, c, s):
    """Rows j, i of every matrix in ``mat`` (B, M, N) <- the plane rotation."""
    rj, ri = mat[:, j].clone(), mat[:, i].clone()
    mat[:, j] = c * rj + s * ri
    mat[:, i] = c * ri - s * rj


def qr_givens_batched(a, cfg: dm.DivisionConfig = dm.TAYLOR, *,
                      via: str = "div", device="cuda"):
    """QR of a batch of matrices: (..., M, N) -> (Q (..., M, M), R (..., M, N)).

    ``a`` moves to ``device`` (pass ``device="cpu"`` to run the plain
    versions on the CPU). R keeps its below-diagonal residues as computed.
    """
    a = torch.as_tensor(a).to(device)
    if a.ndim < 2:
        raise ValueError(f"qr_givens_batched expects (..., M, N), got {tuple(a.shape)}")
    lead, (m, n) = a.shape[:-2], a.shape[-2:]
    r = a.reshape((-1, m, n)).clone()
    qt = torch.eye(m, dtype=a.dtype, device=a.device).expand(r.shape[0], m, m).clone()
    for j in range(min(m - 1, n)):
        for i in range(j + 1, m):
            c, s = givens_coeffs(r[:, j, j], r[:, i, j], cfg, via)
            c, s = c[:, None], s[:, None]
            _rotate_rows(r, j, i, c, s)
            _rotate_rows(qt, j, i, c, s)
    q = qt.transpose(-1, -2)
    return q.reshape(lead + (m, m)), r.reshape(lead + (m, n))


def qr_givens(a, cfg: dm.DivisionConfig = dm.TAYLOR, *, via: str = "div",
              device="cuda"):
    """Full QR of one (M, N) matrix: (Q (M, M), R (M, N)) with A = Q @ R."""
    a = torch.as_tensor(a)
    if a.ndim != 2:
        raise ValueError(f"qr_givens expects a 2D matrix, got shape {tuple(a.shape)}")
    return qr_givens_batched(a, cfg, via=via, device=device)


def qr_givens_sharded(a, cfg: dm.DivisionConfig = dm.TAYLOR, *, via: str = "div",
                      device="cuda"):
    """Batched Givens QR with the batch dim split over the active mesh.

    ``a`` is (B, M, N): a DTensor whose dim 0 is split over the batch axes
    (the largest divisible prefix of ('pod', 'data'),
    ``rules.batch_partition``), or the global batch, the same on every
    rank, of which each rank takes its block. Each rank decomposes its own
    matrices with :func:`qr_givens_batched` (under ``rules.suspend_mesh()``);
    the rotations never leave a matrix, so nothing is communicated and the
    result is the batched run's, bit for bit. Returns (Q, R) as DTensors
    split like ``a``. Without an active mesh, or when no batch-axis prefix
    divides B, this is :func:`qr_givens_batched`.
    """
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding import rules as shr

    if a.ndim != 3:
        raise ValueError(f"qr_givens_sharded wants (B, M, N), got {tuple(a.shape)}")
    mesh = shr.active_mesh()
    axes = shr.batch_partition(mesh, a.shape[0]) if mesh is not None else ()
    if not axes or shr.axes_size(mesh, axes) <= 1:
        return qr_givens_batched(a, cfg, via=via, device=device)
    sharding = shr.batch_sharding(mesh, axes, 3)
    with shr.suspend_mesh():
        q, r = qr_givens_batched(shr.batch_local(a, sharding), cfg, via=via, device=device)
    return tuple(DTensor.from_local(t, mesh, sharding.placements, run_check=False)
                 for t in (q, r))
