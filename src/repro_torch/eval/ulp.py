"""ULP-error engine: exact ULP distance vs the f64 oracle, stratified sweeps.

A numpy copy of the reference's ``src/repro/eval/ulp.py`` (the port imports
nothing of the JAX package); tensors coming out of torch are converted to
numpy first.

The paper's programmable-accuracy claim (eq. 17) ties (n_iters, seed
precision) to delivered output bits; this module is the measuring stick.
Everything is plain numpy on host, so the engine has no opinion about how
the values were produced.

Two distances, for two jobs:

  * :func:`ulp_error` — fractional ULPs between a finite-precision result and
    the *exact* (f64 oracle) value, measured in ULPs of the result dtype at
    the oracle's magnitude. This is the conformance number ("max 0.5 ulp").
  * :func:`ulp_diff` — integer ULP steps between two same-dtype arrays via
    the monotone ordered-integer map. This is the golden-vector / A-vs-B
    number ("goldschmidt is within 1 ulp of factored-taylor").

Sweeps are stratified because uniform sampling never sees the hard cases:
``logspace`` covers the full exponent range, ``mantissa`` is dense in [1, 2)
(where the PWL segments live), ``boundaries`` straddles the seed-table
segment edges by a few ULPs, and ``edges`` is the IEEE corpus (signed zeros,
infs, nan, subnormals, extremes).
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping

import numpy as np

__all__ = [
    "DTYPES", "ulp_size", "to_ordered", "ulp_diff", "ulp_error",
    "oracle_mask", "subnormal_mask", "cliff_guard", "overflow_guard",
    "sweep_logspace", "sweep_mantissa",
    "sweep_boundaries", "sweep_edges", "sweep_subnormals", "stratified_sweep",
    "summarize", "sweep_ratio_extremes", "sweep_quotient_edges",
    "div_edge_pairs", "div_sweep", "sweep_rsqrt_mantissa",
    "sweep_exponent_parity", "rsqrt_sweep",
]


def _resolve_dtype(dtype):
    """Accept 'bfloat16' / np.float32 / jnp dtypes; return a numpy dtype."""
    if isinstance(dtype, str) and dtype == "bfloat16":
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(dtype)


DTYPES = ("float32", "bfloat16")

# (mantissa bits incl. hidden, min normal exponent, max exponent) per format.
_FORMAT = {
    "float16": (11, -14, 15),
    "bfloat16": (8, -126, 127),
    "float32": (24, -126, 127),
    "float64": (53, -1022, 1023),
}


def _fmt(dtype):
    dt = _resolve_dtype(dtype)
    return _FORMAT[dt.name]


def ulp_size(exact: np.ndarray, dtype="float32") -> np.ndarray:
    """ULP of ``dtype`` at the magnitude of ``exact`` (f64), as f64.

    ulp(y) = 2^(max(floor(log2|y|), emin) - (p-1)); the emin clamp makes the
    subnormal range share the smallest-normal ULP (fixed-point spacing).
    """
    p, emin, _ = _fmt(dtype)
    x = np.abs(np.asarray(exact, np.float64))
    frac, e = np.frexp(x)                      # x = frac * 2^e, frac in [0.5,1)
    e = np.where(x == 0, emin + 1, e)          # avoid log of 0; clamped below
    return np.ldexp(1.0, np.maximum(e - 1, emin) - (p - 1))


def to_ordered(x: np.ndarray) -> np.ndarray:
    """Monotone map of IEEE floats to int64 (adjacent floats differ by 1).

    +0 and -0 both map to 0; works for any IEEE format (f16/bf16/f32/f64)
    by viewing the underlying bits.
    """
    x = np.asarray(x)
    int_t = {2: np.int16, 4: np.int32, 8: np.int64}[x.dtype.itemsize]
    bits = x.view(int_t).astype(np.int64)
    mag_mask = np.int64((1 << (x.dtype.itemsize * 8 - 1)) - 1)
    return np.where(bits < 0, -(bits & mag_mask), bits)


def ulp_diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Integer ULP steps between same-dtype arrays; nan-vs-nan counts as 0."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype:
        raise ValueError(f"dtype mismatch: {a.dtype} vs {b.dtype}")
    d = np.abs(to_ordered(a) - to_ordered(b))
    both_nan = np.isnan(a.astype(np.float64)) & np.isnan(b.astype(np.float64))
    return np.where(both_nan, 0, d)


def oracle_mask(exact: np.ndarray, dtype="float32") -> np.ndarray:
    """Inputs whose exact result is a *normal* finite number in ``dtype``.

    ULP statistics are only well-defined there: results that overflow,
    underflow to subnormal/zero, or are inf/nan get their own edge checks
    (hardware units FTZ in that range, by design — see kernels/common.py).
    """
    p, emin, emax = _fmt(dtype)
    ax = np.abs(np.asarray(exact, np.float64))
    tiny = np.ldexp(1.0, emin)
    # Largest finite: (2 - 2^(1-p)) * 2^emax.
    big = np.ldexp(2.0 - 2.0 ** (1 - p), emax)
    return np.isfinite(ax) & (ax >= tiny) & (ax <= big)


def subnormal_mask(x: np.ndarray, dtype="float32") -> np.ndarray:
    """Finite nonzero values strictly below the smallest normal of ``dtype``.

    Under the gradual-underflow policy these lanes carry exact ULP
    statistics (the bit-level jnp datapath normalizes/rounds them); under
    FTZ they are the flush edge class and stay excluded.
    """
    p, emin, _ = _fmt(dtype)
    ax = np.abs(np.asarray(x, np.float64))
    return np.isfinite(ax) & (ax > 0) & (ax < np.ldexp(1.0, emin))


def overflow_guard(exact: np.ndarray, dtype="float32",
                   ulps: float = 2.0) -> np.ndarray:
    """The overflow half of :func:`cliff_guard` on its own.

    Gradual-underflow cells have no flush cliff at the bottom of the normal
    range — quotients there round into the subnormal lattice and are
    measured — so only the largest-finite cliff needs guard-banding.
    """
    p, emin, emax = _fmt(dtype)
    ax = np.abs(np.asarray(exact, np.float64))
    big = np.ldexp(2.0 - 2.0 ** (1 - p), emax)
    return ax <= big - ulps * np.ldexp(1.0, emax - p + 1)


def cliff_guard(exact: np.ndarray, dtype="float32",
                ulps: float = 2.0) -> np.ndarray:
    """Lanes whose exact magnitude sits more than ``ulps`` ULPs inside the
    normal range's cliffs.

    A unit permitted k ULPs of error may legitimately flush a quotient whose
    exact value lies within k ULPs of the smallest normal (FTZ turns the
    miss into -100% error) or overflow one within k ULPs of the largest
    finite. Those lanes belong to the FTZ/overflow edge class, not the ULP
    statistics; AND this with :func:`oracle_mask` for cliff-straddling
    corpora like ``sweep_quotient_edges``.
    """
    p, emin, emax = _fmt(dtype)
    ax = np.abs(np.asarray(exact, np.float64))
    tiny = np.ldexp(1.0, emin)
    big = np.ldexp(2.0 - 2.0 ** (1 - p), emax)
    return ((ax >= tiny * (1.0 + ulps * 2.0 ** (1 - p)))
            & (ax <= big - ulps * np.ldexp(1.0, emax - p + 1)))


def ulp_error(approx: np.ndarray, exact: np.ndarray, dtype="float32",
              where: np.ndarray | None = None) -> np.ndarray:
    """|approx - exact| in ULPs of ``dtype``, elementwise (f64).

    ``approx`` is the finite-precision result (any float dtype), ``exact``
    the f64 oracle. Masked-out lanes (see oracle_mask) return 0.
    """
    approx64 = np.asarray(approx).astype(np.float64)
    exact64 = np.asarray(exact, np.float64)
    mask = oracle_mask(exact64, dtype) if where is None else where
    with np.errstate(invalid="ignore"):   # inf-inf on masked-out lanes
        err = np.where(mask, np.abs(approx64 - exact64), 0.0)
    return err / ulp_size(exact64, dtype)


# ------------------------------------------------------------------- sweeps

def sweep_logspace(n: int = 4096, dtype="float32", seed: int = 0) -> np.ndarray:
    """Signed log-uniform sweep over the full normal exponent range."""
    p, emin, emax = _fmt(dtype)
    rng = np.random.default_rng(seed)
    e = rng.uniform(emin, emax, n)
    s = rng.choice([-1.0, 1.0], n)
    x = s * np.exp2(e)
    return x.astype(_resolve_dtype(dtype))


def sweep_mantissa(n: int = 4096, dtype="float32", seed: int = 1) -> np.ndarray:
    """Dense coverage of [1, 2): grid + jitter, where the PWL segments live."""
    rng = np.random.default_rng(seed)
    grid = 1.0 + np.arange(n) / n
    jit = 1.0 + rng.random(n)
    return np.concatenate([grid, jit]).astype(_resolve_dtype(dtype))


def sweep_boundaries(boundaries: Iterable[float], dtype="float32",
                     ulps: int = 4) -> np.ndarray:
    """Points straddling each seed-segment boundary by -ulps..+ulps steps."""
    dt = _resolve_dtype(dtype)
    base = np.asarray(list(boundaries), np.float64).astype(dt)
    out = [base]
    lo = np.full_like(base, -np.inf, dtype=dt)
    hi = np.full_like(base, np.inf, dtype=dt)
    up, dn = base, base
    for _ in range(ulps):
        # nextafter is not implemented for bf16 — step via the ordered map.
        up = _nextafter(up, hi)
        dn = _nextafter(dn, lo)
        out += [up.copy(), dn.copy()]
    return np.concatenate(out)


def _nextafter(x, towards):
    try:
        return np.nextafter(x, towards)
    except TypeError:  # ml_dtypes formats
        int_t = {2: np.int16, 4: np.int32}[x.dtype.itemsize]
        bits = x.view(int_t)
        step = np.where(towards.astype(np.float64) > x.astype(np.float64), 1, -1)
        step = np.where(x.astype(np.float64) < 0, -step, step).astype(int_t)
        return (bits + step).view(x.dtype)


def sweep_edges(dtype="float32") -> np.ndarray:
    """IEEE edge corpus: signed zeros/infs, nan, extremes, powers of two."""
    p, emin, emax = _fmt(dtype)
    dt = _resolve_dtype(dtype)
    tiny = np.ldexp(1.0, emin)
    big = np.ldexp(2.0 - 2.0 ** (1 - p), emax)
    vals = [0.0, -0.0, np.inf, -np.inf, np.nan,
            1.0, -1.0, 2.0, -2.0, 0.5, -0.5,
            tiny, -tiny, big, -big,
            np.ldexp(1.0, emin - 1), -np.ldexp(1.0, emin - 1),   # subnormal
            np.ldexp(1.0, emax), -np.ldexp(1.0, emax)]
    vals += [np.ldexp(1.0, e) for e in range(emin, emax, 16)]
    return np.asarray(vals, np.float64).astype(dt)


def sweep_subnormals(n: int = 256, dtype="float32", seed: int = 2) -> np.ndarray:
    """Signed subnormal inputs (reciprocal overflows: the FTZ stratum)."""
    p, emin, _ = _fmt(dtype)
    rng = np.random.default_rng(seed)
    tiny = np.ldexp(1.0, emin)
    x = rng.uniform(np.ldexp(1.0, emin - (p - 1)), tiny, n)
    return (x * rng.choice([-1.0, 1.0], n)).astype(_resolve_dtype(dtype))


def stratified_sweep(dtype="float32", n_log: int = 4096, n_man: int = 4096,
                     boundaries: Iterable[float] | None = None,
                     seed: int = 0) -> Dict[str, np.ndarray]:
    """The standard operand corpus, one array per stratum."""
    strata = {
        "logspace": sweep_logspace(n_log, dtype, seed),
        "mantissa": sweep_mantissa(n_man, dtype, seed + 1),
        "edges": sweep_edges(dtype),
        "subnormals": sweep_subnormals(256, dtype, seed + 2),
    }
    if boundaries is not None:
        strata["boundaries"] = sweep_boundaries(boundaries, dtype)
    return strata


# --------------------------------------------------------------- div sweeps
#
# Divide needs *pairs*: the hard cases are relations between numerator and
# denominator (ratio representable while the intermediate reciprocal is not;
# quotient a few ULPs from the overflow/underflow cliff), which no product of
# independent single-operand sweeps reaches with useful density.

def sweep_ratio_extremes(n: int = 2048, dtype="float32",
                         seed: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """(a, b) with a/b a normal number while 1/b is subnormal or inexact.

    The killer corpus for ``a * recip(b)`` divides: |b| sits within a few
    octaves of 2^emax, so the intermediate reciprocal under/overflows (f32:
    1/b < 2^-126) even though the quotient's exponent is unremarkable. An
    exponent-separated datapath is flat here; the composed one was measured
    at 1.6e7 max ULP.
    """
    p, emin, emax = _fmt(dtype)
    rng = np.random.default_rng(seed)
    dt = _resolve_dtype(dtype)
    # |b| = 2^(eb-1) * [1,2) in [2^(emax-1), 2^(emax+1)) => 1/|b| at or
    # below the smallest normal on every lane: the true recip-underflow class.
    eb = rng.uniform(emax, emax + 1, n)
    # Quotient exponent anywhere representable given ea <= emax.
    eq = rng.uniform(emin + 2, np.minimum(emax - eb, emax) - 1, n)
    b = (rng.choice([-1.0, 1.0], n) * np.exp2(eb)
         * rng.uniform(1.0, 2.0, n) / 2.0).astype(dt)
    a = (rng.choice([-1.0, 1.0], n) * np.exp2(eq + eb)
         * rng.uniform(1.0, 2.0, n) / 2.0).astype(dt)
    return a, b


def sweep_quotient_edges(n: int = 1024, dtype="float32",
                         seed: int = 4) -> tuple[np.ndarray, np.ndarray]:
    """(a, b) whose exact quotient straddles the overflow/underflow cliffs.

    Targets land log-uniformly within one octave on either side of the
    largest-finite and smallest-normal magnitudes; a is chosen as
    round(q_target * b) so the realized ratio stays on target to ~1 ULP.
    Only the representable side contributes ULP statistics (oracle_mask);
    the far side exercises the overflow->inf / FTZ->0 contract.
    """
    p, emin, emax = _fmt(dtype)
    rng = np.random.default_rng(seed)
    dt = _resolve_dtype(dtype)
    half = n // 2
    big = np.ldexp(2.0 - 2.0 ** (1 - p), emax)
    tiny = np.ldexp(1.0, emin)
    targets = np.concatenate([
        big * np.exp2(rng.uniform(-1, 1, half)),      # straddle overflow
        tiny * np.exp2(rng.uniform(-1, 1, n - half)), # straddle underflow
    ]) * rng.choice([-1.0, 1.0], n)
    # Denominators mid-range so a = q*b stays representable for the
    # overflow half (|q| ~ 2^128 needs |b| <~ 1) and the underflow half.
    eb = np.where(np.abs(targets) > 1.0,
                  rng.uniform(emin / 2, -1.0, n),
                  rng.uniform(1.0, emax / 2, n))
    b = (rng.choice([-1.0, 1.0], n) * np.exp2(eb)
         * rng.uniform(1.0, 2.0, n) / 2.0).astype(dt)
    a = (targets * b.astype(np.float64)).astype(dt)
    return a, b


def div_edge_pairs(dtype="float32") -> tuple[np.ndarray, np.ndarray]:
    """Full cross product of the IEEE edge corpus against itself.

    Covers every special-value combination for a/b: +-0/x, x/+-0, 0/0,
    inf/inf, inf/x, x/inf, nan propagation, subnormal operands (the FTZ
    class), and extreme-magnitude normals.
    """
    base = sweep_edges(dtype)
    a = np.repeat(base, base.size)
    b = np.tile(base, base.size)
    return a, b


def div_sweep(dtype="float32", n_log: int = 4096, n_man: int = 4096,
              boundaries: Iterable[float] | None = None,
              seed: int = 0) -> Dict[str, tuple[np.ndarray, np.ndarray]]:
    """The standard divide corpus: one (a, b) pair of arrays per stratum."""
    dt = _resolve_dtype(dtype)
    b_log = sweep_logspace(n_log, dtype, seed)
    a_log = sweep_logspace(n_log, dtype, seed + 7)
    b_man = sweep_mantissa(n_man, dtype, seed + 1)
    a_man = sweep_mantissa(n_man, dtype, seed + 8)[::-1].copy()
    b_sub = sweep_subnormals(256, dtype, seed + 2)
    a_sub = sweep_logspace(b_sub.size, dtype, seed + 9)
    strata: Dict[str, tuple[np.ndarray, np.ndarray]] = {
        "logspace": (a_log, b_log),
        "mantissa": (a_man, b_man),
        "ratio_extremes": sweep_ratio_extremes(2048, dtype, seed + 3),
        "quotient_edges": sweep_quotient_edges(1024, dtype, seed + 4),
        "edges": div_edge_pairs(dtype),
        "subnormals": (a_sub, b_sub),
    }
    if boundaries is not None:
        b_bnd = sweep_boundaries(boundaries, dtype)
        a_bnd = sweep_logspace(b_bnd.size, dtype, seed + 5).astype(dt)
        strata["boundaries"] = (a_bnd[:b_bnd.size], b_bnd)
    return strata


# ------------------------------------------------------------- rsqrt sweeps
#
# rsqrt is a single-operand op, but its hard cases are structured by the
# exponent's *parity* (the datapath splits even/odd exponents onto one seed
# octave) and by the two-octave mantissa domain [1, 4): a corpus that only
# covers [1, 2) never exercises the odd-exponent half of the seed table.

def sweep_rsqrt_mantissa(n: int = 4096, dtype="float32",
                         seed: int = 5) -> np.ndarray:
    """Dense coverage of [1, 2) ∪ [2, 4): grid + jitter over both octaves.

    rsqrt folds its operand onto one reduced interval per exponent *parity*,
    so the mantissa-dense corpus must span two octaves where the reciprocal
    corpus needs one.
    """
    rng = np.random.default_rng(seed)
    half = n // 2
    grid_lo = 1.0 + np.arange(half) / half           # [1, 2)
    grid_hi = 2.0 + 2.0 * np.arange(n - half) / (n - half)   # [2, 4)
    jit = 1.0 + 3.0 * rng.random(n)                  # [1, 4)
    return np.concatenate([grid_lo, grid_hi, jit]).astype(_resolve_dtype(dtype))


def sweep_exponent_parity(n: int = 2048, dtype="float32",
                          seed: int = 6) -> np.ndarray:
    """Positive operands split half even / half odd unbiased exponents.

    The rsqrt exponent is halved (2^e -> 2^-e/2), with the parity bit folded
    into the mantissa domain; this stratum pins both halves of that split
    across the full exponent range, including exact powers of two.
    """
    p, emin, emax = _fmt(dtype)
    rng = np.random.default_rng(seed)
    half = n // 2
    e_even = 2 * rng.integers(emin // 2 + 1, emax // 2, half)
    e_odd = 2 * rng.integers(emin // 2 + 1, emax // 2, n - half) + 1
    e = np.concatenate([e_even, e_odd]).astype(np.float64)
    man = np.concatenate([np.ones(n // 4),                  # exact 2^e
                          1.0 + rng.random(n - n // 4)])    # jittered
    return (man[:n] * np.exp2(e)).astype(_resolve_dtype(dtype))


def rsqrt_sweep(dtype="float32", n_log: int = 4096, n_man: int = 4096,
                seed: int = 0) -> Dict[str, np.ndarray]:
    """The standard rsqrt operand corpus, one array per stratum.

    Positive-only ULP strata (negatives are a nan contract, covered by the
    ``edges`` stratum), plus the subnormal stratum — rsqrt of every positive
    subnormal is a mid-range normal, so under gradual underflow these lanes
    carry exact ULP statistics rather than an FTZ class.
    """
    return {
        "logspace": np.abs(sweep_logspace(n_log, dtype, seed)),
        "exp_parity": sweep_exponent_parity(max(n_log // 2, 16), dtype,
                                            seed + 11),
        "mantissa": sweep_rsqrt_mantissa(n_man, dtype, seed + 12),
        "edges": sweep_edges(dtype),
        "subnormals": np.abs(sweep_subnormals(256, dtype, seed + 13)),
    }


def summarize(errs: np.ndarray, mask: np.ndarray | None = None) -> Dict[str, float]:
    """max/mean/p99 ULP over the oracle-valid lanes."""
    e = np.asarray(errs, np.float64)
    if mask is not None:
        e = e[mask]
    if e.size == 0:
        return {"max_ulp": 0.0, "mean_ulp": 0.0, "p99_ulp": 0.0, "n": 0}
    with np.errstate(invalid="ignore"):   # percentile interpolation with infs
        p99 = float(np.percentile(e, 99))
    return {
        "max_ulp": float(e.max()),
        "mean_ulp": float(e.mean()),
        "p99_ulp": p99,
        "n": int(e.size),
    }
