"""Consumer-conformance corpora and oracles: softmax / rmsnorm row sweeps.

A numpy copy of the reference's ``src/repro/eval/consumers.py`` (the port
imports nothing of the JAX package): the same seeded corpora, f64 oracles,
metrics and gates, so the port's consumers are held to the reference's
numbers on the reference's inputs.

The division unit's flagship consumers (normalization: attention softmax,
RMSNorm) get the same measuring stick the scalar ops have had since PR 1 —
stratified operand corpora, an f64 oracle, and metrics that isolate what the
*unit* contributes from what the surrounding kernel (exp, sum-of-squares)
contributes:

  * vs-f64-oracle fractional ULP stats (informational): dominated by the
    consumer's own transcendental/reduction error on hard strata — an f32
    ``exp`` amplifies argument rounding by |arg|, so wide-dynamic-range rows
    legitimately measure thousands of oracle ULPs *in every mode including
    exact*. Reported per stratum, never gated.
  * vs-exact-twin integer ULP (gated): the same consumer computation with
    ``cfg=EXACT`` shares every exp/sum rounding, so the diff isolates the
    division unit's contribution (reciprocal or rsqrt error plus one final
    multiply). Documented tolerance: ``VS_EXACT_GATE_ULP``.
  * row-sum accuracy (softmax, gated): |sum(row) - 1| in ULP-equivalents of
    1.0 (units of 2^(1-p) for the output dtype). The computed outputs are
    ``ex_i * recip(s)`` with s the sum of the *computed* ex, so the exp
    errors cancel and the row sum isolates the reciprocal:
    |sum - 1| <= recip error (<= 1 ULP) + weighted per-element rounding
    (<= 0.5 ULP) — the non-ILM gate is ``ROW_SUM_GATE_ULP`` = 2.

Strata are chosen for the consumer's hard cases: ``wide_range`` rows push
outputs across the full normal/subnormal probability range, ``denormal``
rows carry logits that are themselves subnormal (the gradual-underflow
operand class), ``peaked``/``ties`` rows pin the one-hot and exactly-uniform
limits, and rmsnorm's ``tiny``/``huge`` rows drive the mean-of-squares to
where eps dominates or the square approaches overflow.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from . import ulp

__all__ = [
    "CONSUMER_OPS", "ROW_SUM_GATE_ULP", "VS_EXACT_GATE_ULP",
    "softmax_rows", "softmax_edge_rows", "softmax_oracle",
    "rmsnorm_rows", "rmsnorm_weight", "rmsnorm_oracle",
    "row_sum_ulp1", "vs_exact_int_ulp",
]

CONSUMER_OPS = ("softmax", "rmsnorm")

# Row sums within 2 ULP-equivalents of 1.0 for every non-ILM mode (the
# acceptance gate): 1 ULP reciprocal error + <= 0.5 ULP weighted rounding.
ROW_SUM_GATE_ULP = 2.0

# Elementwise distance from the cfg=EXACT twin on oracle-normal lanes:
# the unit's recip/rsqrt error (<= 1 ULP) vs the exact op (<= 0.5 / 1.36
# ULP for divide / lax.rsqrt) plus the final multiply roundings.
VS_EXACT_GATE_ULP = 4


def softmax_rows(dtype="float32", n_rows: int = 64, d: int = 128,
                 seed: int = 0) -> Dict[str, np.ndarray]:
    """The stratified softmax logit corpus, one (n_rows, d) array per stratum."""
    rng = np.random.default_rng(seed)
    dt = ulp._resolve_dtype(dtype)
    gaussian = rng.normal(0.0, 4.0, (n_rows, d))
    # Full exp dynamic range: differences up to ~174 push output
    # probabilities from ~1 down through the subnormal lattice to zero.
    wide = rng.uniform(-87.0, 87.0, (n_rows, d))
    # Logits that are themselves subnormal: softmax is ~uniform with
    # sub-ULP differences — the gradual-underflow operand class.
    mag = np.exp2(rng.uniform(-149.0, -126.0, (n_rows, d)))
    denormal = mag * rng.choice([-1.0, 1.0], (n_rows, d))
    # One dominating logit per row: the one-hot limit (survivor ~ 1.0).
    peaked = rng.normal(0.0, 1.0, (n_rows, d))
    peaked[np.arange(n_rows), rng.integers(0, d, n_rows)] += 100.0
    # Exactly-tied rows: softmax must deliver 1/d per element.
    ties = np.repeat(rng.normal(0.0, 10.0, (n_rows, 1)), d, axis=1)
    return {
        "gaussian": gaussian.astype(dt),
        "wide_range": wide.astype(dt),
        "denormal_logits": denormal.astype(dt),
        "peaked": peaked.astype(dt),
        "ties": ties.astype(dt),
    }


def softmax_edge_rows(dtype="float32", d: int = 16) -> np.ndarray:
    """Edge-contract rows: fully-masked (all -inf), single-survivor, nan.

    Row 0 (all -inf) must come out all zeros in every mode (the masked-
    softmax contract — never 0 * recip(0) = nan); row 1 keeps one finite
    logit whose probability must be 1 (within a couple of ULPs) with zeros
    elsewhere; row 2 must propagate nan.
    """
    dt = ulp._resolve_dtype(dtype)
    rows = np.full((3, d), -np.inf)
    rows[1, 0] = 0.5
    rows[2, :] = 1.0
    rows[2, d // 2] = np.nan
    return rows.astype(dt)


def softmax_oracle(x64: np.ndarray) -> np.ndarray:
    """f64 stable softmax over the last axis; fully-masked rows -> zeros."""
    x64 = np.asarray(x64, np.float64)
    m = np.max(x64, axis=-1, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    ex = np.exp(x64 - m)
    s = np.sum(ex, axis=-1, keepdims=True)
    return ex / np.where(s == 0, 1.0, s)


def rmsnorm_rows(dtype="float32", n_rows: int = 64, d: int = 128,
                 seed: int = 0) -> Dict[str, np.ndarray]:
    """The stratified rmsnorm activation corpus, one (n_rows, d) per stratum."""
    rng = np.random.default_rng(seed + 17)
    dt = ulp._resolve_dtype(dtype)
    gaussian = rng.normal(0.0, 3.0, (n_rows, d))
    # Rows scaled across ~24 octaves either way: the mean-of-squares spans
    # [2^-80, 2^80] while staying far from f32 overflow in the squares.
    scales = np.exp2(rng.uniform(-40.0, 40.0, (n_rows, 1)))
    scaled = rng.normal(0.0, 1.0, (n_rows, d)) * scales
    # Tiny rows where eps dominates mean(x^2): the rsqrt argument is ~eps.
    tiny = rng.normal(0.0, 1.0, (n_rows, d)) * np.exp2(-40.0)
    return {
        "gaussian": gaussian.astype(dt),
        "wide_scale": scaled.astype(dt),
        "eps_dominated": tiny.astype(dt),
    }


def rmsnorm_weight(d: int = 128, seed: int = 0) -> np.ndarray:
    """Deterministic f32 weight vector shared by all rmsnorm strata."""
    return np.random.default_rng(seed + 23).normal(
        1.0, 0.5, (d,)).astype(np.float32)


def rmsnorm_oracle(x64: np.ndarray, w64: np.ndarray,
                   eps: float = 1e-6) -> np.ndarray:
    """f64 RMSNorm over the last axis."""
    x64 = np.asarray(x64, np.float64)
    ss = np.mean(x64 * x64, axis=-1, keepdims=True)
    return x64 / np.sqrt(ss + eps) * np.asarray(w64, np.float64)


def row_sum_ulp1(out, dtype="float32") -> np.ndarray:
    """|sum(row) - 1| per row, in ULP-equivalents of 1.0 for ``dtype``.

    The sum runs in f64 over the finite-precision outputs, so the metric
    carries only the consumer's error, not the measurement's. One
    ULP-equivalent is the spacing just above 1.0: 2^(1-p).
    """
    p, _, _ = ulp._fmt(dtype)
    s = np.sum(np.asarray(out, np.float64), axis=-1)
    return np.abs(s - 1.0) / (2.0 ** (1 - p))


def vs_exact_int_ulp(out, exact_twin, oracle64, dtype="float32") -> int:
    """Max integer ULP steps from the cfg=EXACT twin on oracle-normal lanes.

    Lanes whose exact (f64) result is subnormal/zero/inf are excluded:
    under the kernels' FTZ contract a flushed probability sits an entire
    subnormal range of integer steps from the twin's gradual value, which
    is the underflow policy's business (tests/test_underflow_policy.py),
    not the consumer gate's.
    """
    d = ulp.ulp_diff(np.asarray(out), np.asarray(exact_twin))
    mask = ulp.oracle_mask(np.asarray(oracle64, np.float64), dtype)
    d = np.where(mask, d, 0)
    return int(d.max()) if d.size else 0
