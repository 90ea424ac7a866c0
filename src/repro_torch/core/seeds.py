"""Piecewise-linear seed tables for the Taylor-series reciprocal (paper §3).

A numpy copy of the reference's table generation (``src/repro/core/seeds.py``),
kept here so the port imports nothing of the JAX package. Tables are computed
once, in float64, from ``(n_iters, precision_bits)``; they are the unit's
"parameters" and must be ``np.array_equal`` to the reference's:

  * the optimal single-segment linear seed  y0 = -4x/(a+b)^2 + 4/(a+b)
    (paper eq. 15);
  * the per-segment error bound of the n-term Taylor refinement (eq. 17):
    E_n <= ((a+b)^2 / 4ab)^(n+2) * m_max^(n+1),  m_max = ((b-a)/(a+b))^2;
  * the segment-boundary recurrence (eq. 19/20): grow segments left to right
    so each one just meets the precision in n iterations.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

__all__ = ["SeedTable", "linear_seed_coeffs", "seed_max_m", "seed_error_bound",
           "iterations_required", "compute_segments", "rsqrt_seed_table",
           "PAPER_TABLE_I"]

# Paper Table I (n = 5, 53-bit precision): reproduced by compute_segments(5, 53).
PAPER_TABLE_I = [1.09811, 1.20835, 1.3269, 1.45709, 1.59866, 1.75616, 1.92922, 2.12392]


def linear_seed_coeffs(a: float, b: float) -> tuple[float, float]:
    """(slope, intercept) of the optimal linear 1/x on [a, b] (eq. 15)."""
    p = 0.5 * (a + b)
    return (-1.0 / (p * p), 2.0 / p)


def seed_max_m(a: float, b: float) -> float:
    """max_x |1 - x*y0(x)| over [a, b] for the optimal seed: ((b-a)/(a+b))^2."""
    return ((b - a) / (a + b)) ** 2


def seed_error_bound(a: float, b: float, n: int) -> float:
    """Eq. 17: bound on the reciprocal error after n Taylor terms."""
    amp = (a + b) ** 2 / (4.0 * a * b)
    return amp ** (n + 2) * seed_max_m(a, b) ** (n + 1)


def iterations_required(a: float, b: float, precision_bits: int, n_max: int = 64) -> int:
    """Smallest n with seed_error_bound(a, b, n) <= 2^-precision_bits; the
    paper's §3 claim (1, 2, 53 bits) -> 17 iterations."""
    target = 2.0 ** (-precision_bits)
    for n in range(n_max + 1):
        if seed_error_bound(a, b, n) <= target:
            return n
    raise ValueError(f"no n <= {n_max} meets 2^-{precision_bits} on [{a},{b}]")


def _next_boundary(a: float, n: int, precision_bits: int, b_cap: float = 16.0) -> float:
    """Largest b > a with seed_error_bound(a, b, n) <= 2^-precision_bits (eq. 20)."""
    target = 2.0 ** (-precision_bits)
    lo, hi = a, a * 1.0000001
    while seed_error_bound(a, hi, n) <= target:
        lo = hi
        hi = a + (hi - a) * 2.0
        if hi > b_cap:
            return b_cap
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if seed_error_bound(a, mid, n) <= target:
            lo = mid
        else:
            hi = mid
        if hi - lo <= np.finfo(np.float64).eps * hi:
            break
    return lo


@dataclass(frozen=True)
class SeedTable:
    """PWL seed table: segment i covers [boundaries[i], boundaries[i+1])."""

    n_iters: int
    precision_bits: int
    boundaries: np.ndarray  # (n_segments + 1,)
    slopes: np.ndarray      # (n_segments,)
    intercepts: np.ndarray  # (n_segments,)

    @property
    def n_segments(self) -> int:
        return len(self.slopes)

    @property
    def inner_boundaries(self) -> np.ndarray:
        """Thresholds for segment lookup: idx = sum(x >= inner_boundaries)."""
        return self.boundaries[1:-1]

    def seed(self, x):
        """Vectorized numpy seed evaluation (the f64 ILM oracle's seed)."""
        x = np.asarray(x)
        idx = np.sum(x[..., None] >= self.inner_boundaries, axis=-1)
        return self.slopes[idx] * x + self.intercepts[idx]

    def max_error_bound(self, n: int | None = None) -> float:
        """The largest eq. 17 bound over the segments after n terms
        (the table's own n_iters by default)."""
        n = self.n_iters if n is None else n
        return max(seed_error_bound(float(a), float(b), n)
                   for a, b in zip(self.boundaries[:-1], self.boundaries[1:]))


@lru_cache(maxsize=None)
def compute_segments(n_iters: int, precision_bits: int, lo: float = 1.0,
                     hi: float = 2.0) -> SeedTable:
    """Paper §3 procedure: grow segments until b_k >= hi."""
    bounds = [lo]
    while bounds[-1] < hi:
        nxt = _next_boundary(bounds[-1], n_iters, precision_bits)
        if nxt <= bounds[-1] * (1 + 1e-12):
            raise ValueError(
                f"segment collapsed at {bounds[-1]}: n={n_iters} cannot reach "
                f"2^-{precision_bits}; increase n_iters")
        bounds.append(nxt)
    coeffs = [linear_seed_coeffs(a, b) for a, b in zip(bounds[:-1], bounds[1:])]
    return SeedTable(
        n_iters=n_iters,
        precision_bits=precision_bits,
        boundaries=np.asarray(bounds, np.float64),
        slopes=np.asarray([s for s, _ in coeffs], np.float64),
        intercepts=np.asarray([c for _, c in coeffs], np.float64),
    )


@lru_cache(maxsize=None)
def rsqrt_seed_table(n_segments: int = 16, lo: float = 0.5, hi: float = 2.0) -> SeedTable:
    """PWL chord seed for 1/sqrt(x) on [lo, hi), log-uniform segments."""
    ratio = (hi / lo) ** (1.0 / n_segments)
    bounds = np.array([lo * ratio**i for i in range(n_segments + 1)], np.float64)
    f = lambda t: 1.0 / math.sqrt(t)
    slopes, intercepts = [], []
    for a, b in zip(bounds[:-1], bounds[1:]):
        s = (f(b) - f(a)) / (b - a)
        slopes.append(s)
        intercepts.append(f(a) - s * a)
    # Worst-case relative seed error of the chords, on a dense grid.
    xs = np.linspace(lo, hi, 20001)
    idx = np.minimum(np.searchsorted(bounds, xs, side="right") - 1, n_segments - 1)
    seed = np.asarray(slopes)[idx] * xs + np.asarray(intercepts)[idx]
    rel = np.max(np.abs(seed * np.sqrt(xs) - 1.0))
    prec = int(-math.log2(rel)) if rel > 0 else 60
    return SeedTable(
        n_iters=0,
        precision_bits=prec,
        boundaries=bounds,
        slopes=np.asarray(slopes, np.float64),
        intercepts=np.asarray(intercepts, np.float64),
    )
