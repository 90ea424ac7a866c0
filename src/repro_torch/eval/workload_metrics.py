"""Workload-level accuracy metrics for the division-consumer workloads.

A numpy copy of the reference's ``src/repro/eval/workload_metrics.py``.

The ULP machinery in :mod:`repro_torch.eval.ulp` judges the division unit op by
op; this module judges it *through a workload*: how far does K-Means'
objective or a Givens QR drift when every divide goes through an
approximate mode instead of torch's divider? All metrics are computed in
float64 numpy regardless of the input dtype, so the measurement never adds
error of its own.

  * :func:`relative_delta`          — |approx - exact| / max(|exact|, tiny):
    the clustering-inertia delta between a mode and its exact twin.
  * :func:`orthogonality_residual`  — ||Q^T Q - I||_F / sqrt(M): how far Q
    drifted off the orthogonal manifold.
  * :func:`reconstruction_residual` — ||Q R - A||_F / ||A||_F.
  * :func:`triangularity_residual`  — ||tril(R, -1)||_F / ||R||_F: how well
    the rotations actually annihilated the subdiagonal (qr_givens returns R
    as computed, not hard-zeroed).
  * :func:`qr_residuals`            — the three QR numbers as one dict, the
    numbers ``chip_smoke.py`` gates per mode.

Consumed by ``tests/test_torch_workloads.py`` and ``chip_smoke.py``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["relative_delta", "orthogonality_residual",
           "reconstruction_residual", "triangularity_residual",
           "qr_residuals"]


def _f64(x) -> np.ndarray:
    return np.asarray(x).astype(np.float64)


def relative_delta(approx, exact, tiny: float = 1e-30) -> float:
    """max over elements of |approx - exact| / max(|exact|, tiny)."""
    a, e = _f64(approx), _f64(exact)
    return float(np.max(np.abs(a - e) / np.maximum(np.abs(e), tiny)))


def orthogonality_residual(q) -> float:
    """||Q^T Q - I||_F / sqrt(M) — scale-free distance from orthogonality."""
    q = _f64(q)
    m = q.shape[-1]
    gram = q.T @ q
    return float(np.linalg.norm(gram - np.eye(m)) / np.sqrt(m))


def reconstruction_residual(q, r, a) -> float:
    """||Q R - A||_F / ||A||_F."""
    q, r, a = _f64(q), _f64(r), _f64(a)
    denom = np.linalg.norm(a)
    return float(np.linalg.norm(q @ r - a) / max(denom, 1e-30))


def triangularity_residual(r) -> float:
    """||tril(R, -1)||_F / ||R||_F — the un-annihilated subdiagonal mass."""
    r = _f64(r)
    denom = np.linalg.norm(r)
    return float(np.linalg.norm(np.tril(r, -1)) / max(denom, 1e-30))


def qr_residuals(q, r, a) -> Dict[str, float]:
    """All three QR quality numbers for one (Q, R, A) triple."""
    return {
        "orthogonality": orthogonality_residual(q),
        "reconstruction": reconstruction_residual(q, r, a),
        "triangularity": triangularity_residual(r),
    }
