"""Plain PyTorch versions of the fused division-unit kernels.

Each function here computes, with torch ops, exactly the bits its CUDA
counterpart in ``csrc/tsdiv_body.cuh`` computes; both reproduce the
reference's Pallas kernel bodies (``src/repro/kernels/common.py``:
``recip_f32_bits``, ``divide_f32_bits``, ``rsqrt_f32_bits``, and the norms'
``rsqrt_f32``). :func:`row_sum` is the consumer kernels' reduction order
(``csrc/rows.cuh``). The wrappers in :mod:`.tsdiv`, :mod:`.softmax` and
:mod:`.rmsnorm` run these for CPU tensors, and ``chip_smoke.py`` holds each
kernel to its plain version on the card.

Two facts of the reference's compiled kernels are reproduced on purpose:

  * **Fused multiply-adds.** The compiled reference contracts ``x + a*b``
    into one fused multiply-add wherever the product has no other use: the
    seed ladder, the final ``y0 + y0*s``, the series updates, the Goldschmidt
    ``n + n*r``, the Markstein ``q0 + res*rman`` and the three Newton sites.
    Those sites, and no others, use :func:`fma` here (and ``__fmaf_rn`` in
    the CUDA body, which is built with ``-fmad=false``). Against the
    reference's kernels in CPU interpret mode this placement gives 0
    differing lanes for every op and schedule
    (``tests/test_torch_tsdiv.py``); rounding them twice instead moves
    some lanes by 1-2 int ulp (``test_the_fused_sites_are_needed``).
  * **Flush to zero.** XLA on the CPU flushes subnormal products; torch and
    CUDA keep them. The reciprocal body therefore flushes results below
    2^-126 explicitly after ``rman * scale`` (the divide body already does).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import fpparts, goldschmidt, taylor
from repro_torch.core.seeds import SeedTable

__all__ = ["fma", "seed_ladder", "series_refine", "recip_f32_bits",
           "divide_f32_bits", "rsqrt_f32_bits", "rsqrt_f32", "REDUCE_THREADS",
           "row_sum"]

_I32 = torch.int32
_F32 = torch.float32
_TINY = 2.0 ** -126
_NAN_BITS = 0x7FC0_0000


def _as_f32(v, like: torch.Tensor) -> torch.Tensor:
    return v if torch.is_tensor(v) else torch.tensor(v, dtype=_F32,
                                                      device=like.device)


def fma(a, b, c):
    """f32 fused multiply-add: a*b + c with a single rounding.

    torch has no f32 fma, so it is computed in f64: the product of two f32
    values is exact there, and the sum is rounded to odd (TwoSum error,
    then the last bit forced to 1 on an inexact sum). A value rounded to
    odd with 29 spare bits rounds to f32 exactly as the infinitely precise
    sum would, so there is no double-rounding error.
    """
    like = next(t for t in (a, b, c) if torch.is_tensor(t))
    a, b, c = (_as_f32(v, like).double() for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    to_odd = (err != 0) & torch.isfinite(err) & ((bits & 1) == 0)
    step = torch.where((err > 0) == (s > 0), 1, -1)   # away from / toward 0
    return torch.where(to_odd, bits + step, bits).view(torch.float64).to(_F32)


def seed_ladder(man: torch.Tensor, table: SeedTable) -> torch.Tensor:
    """PWL seed with the fused slope*man + intercept of the compiled ladder."""
    return taylor.seed_eval(man, table, fma)


def series_refine(y0, man, n: int, schedule: str):
    """y0 * sum_{k<=n'} m^k with m = 1 - man*y0 (or Goldschmidt's recurrence)."""
    if n <= 0:
        return y0
    if schedule == "goldschmidt":
        return goldschmidt.refine(y0, man, y0, goldschmidt.iters_for_terms(n),
                                  madd=fma)
    s = taylor.series_sum(taylor.exact_residual(man, y0), n, schedule, fma)
    return fma(y0, s, y0)


def _f32(bits):
    return bits.view(_F32)


def recip_f32_bits(x: torch.Tensor, table: SeedTable, n: int,
                   schedule: str) -> torch.Tensor:
    """Full f32 reciprocal, FTZ: zero/subnormal -> signed inf, inf -> signed
    0, nan -> nan, results below the normal range -> signed 0."""
    bits = x.contiguous().view(_I32)
    sign = bits & fpparts.F32_SIGN
    exp = (bits >> 23) & 0xFF
    man_bits = bits & fpparts.F32_MAN_MASK
    man = _f32(man_bits | fpparts.F32_ONE_BITS)
    rman = series_refine(seed_ladder(man, table), man, n, schedule)
    # 2^-(exp-127) has biased exponent 254-exp. The reference's uint32 wraps
    # at exp = 255 where this int32 gives -1; the edge table overwrites both.
    scale = _f32(torch.clamp(254 - exp, 0, 254) << 23)
    r = rman * scale
    r = torch.where(r.abs() < _TINY, 0.0, r)
    r = torch.where(exp == 0, math.inf, r)
    r = torch.where((exp == 255) & (man_bits == 0), 0.0, r)
    r = _f32(r.view(_I32) | sign)
    return torch.where((exp == 255) & (man_bits != 0), _f32(
        torch.tensor(_NAN_BITS, dtype=_I32, device=x.device)), r)


def _pow2(k):
    """2^k for int32 k in [-126, 127], by biased-exponent bit cast."""
    return _f32(torch.clamp(k + 127, 1, 254) << 23)


def divide_f32_bits(a: torch.Tensor, b: torch.Tensor, table: SeedTable,
                    n: int, schedule: str) -> torch.Tensor:
    """Fused exponent-separated a/b, FTZ, with the IEEE edge table."""
    abits = a.contiguous().view(_I32)
    bbits = b.contiguous().view(_I32)
    sign = (abits ^ bbits) & fpparts.F32_SIGN
    ea = (abits >> 23) & 0xFF
    eb = (bbits >> 23) & 0xFF
    amant = abits & fpparts.F32_MAN_MASK
    bmant = bbits & fpparts.F32_MAN_MASK
    man_a = _f32(amant | fpparts.F32_ONE_BITS)
    man_b = _f32(bmant | fpparts.F32_ONE_BITS)
    y0 = seed_ladder(man_b, table)
    if schedule == "goldschmidt":
        q_man = goldschmidt.refine(man_a * y0, man_b, y0,
                                   goldschmidt.iters_for_terms(n), madd=fma)
    else:
        rman = series_refine(y0, man_b, n, schedule)
        q_man = fpparts.refine_quotient(man_a * rman, man_a, man_b, rman, fma)
    de = ea - eb
    h = de >> 1                                     # floor(de / 2)
    q = (q_man * _pow2(h)) * _pow2(de - h)
    q = torch.where(q.abs() < _TINY, 0.0, q)
    a_zero, b_zero = ea == 0, eb == 0
    a_inf = (ea == 255) & (amant == 0)
    b_inf = (eb == 255) & (bmant == 0)
    nan = _f32(torch.tensor(_NAN_BITS, dtype=_I32, device=a.device))
    q = torch.where(b_zero, math.inf, q)
    q = torch.where(a_zero, 0.0, q)
    q = torch.where(a_inf, math.inf, q)
    q = torch.where(b_inf, 0.0, q)
    q = torch.where(a_zero & b_zero, nan, q)
    q = torch.where(a_inf & b_inf, nan, q)
    q = _f32(q.view(_I32) | sign)
    a_nan = (ea == 255) & (amant != 0)
    b_nan = (eb == 255) & (bmant != 0)
    return torch.where(a_nan | b_nan, nan, q)


def rsqrt_f32_bits(x: torch.Tensor, table: SeedTable,
                   newton_iters: int) -> torch.Tensor:
    """Full-edge f32 rsqrt, FTZ: zero/subnormal -> signed inf, +inf -> +0,
    negatives (including -inf) and nans -> nan."""
    bits = x.contiguous().view(_I32)
    sign = bits & fpparts.F32_SIGN
    mag = bits & fpparts.F32_MAG_MASK
    exp = (bits >> 23) & 0xFF
    man_bits = bits & fpparts.F32_MAN_MASK
    x_zero = exp == 0
    x_inf = mag == fpparts.F32_EXP_MASK
    x_nan = mag > fpparts.F32_EXP_MASK
    man = _f32(man_bits | fpparts.F32_ONE_BITS)
    ef = exp - 127 + 1                       # |x| = (man/2) * 2^ef
    s = ef >> 1                              # floor(ef / 2)
    odd = ef - 2 * s
    u = torch.where(odd == 1, man, man * 0.5)
    y = taylor.newton_rsqrt(u, seed_ladder(u, table), newton_iters, fma)
    r = y * _f32(torch.clamp(127 - s, 1, 254) << 23)   # exact: r is normal
    r = torch.where(x_zero, _f32(fpparts.F32_EXP_MASK | sign), r)
    r = torch.where(x_inf, 0.0, r)
    neg = (sign != 0) & ~x_zero
    nan = _f32(torch.tensor(_NAN_BITS, dtype=_I32, device=x.device))
    return torch.where(neg | x_nan, nan, r)


def rsqrt_f32(x: torch.Tensor, table: SeedTable,
              newton_iters: int) -> torch.Tensor:
    """rsqrt for strictly positive normal x: the norms' variant, no edges.

    Not :func:`rsqrt_f32_bits`: the exponent is unbiased without the +1 of
    the frexp convention, ``u = where(odd, man*2, man) * 0.5`` and the
    result is assembled as ``(y * (1/sqrt 2)) * 2^-s`` with two roundings.
    The sign bit is ignored and zero, subnormal, inf and nan inputs give
    whatever the arithmetic gives: the caller pins those classes.
    """
    bits = x.contiguous().view(_I32)
    exp = ((bits >> 23) & 0xFF) - 127
    man = _f32((bits & fpparts.F32_MAN_MASK) | fpparts.F32_ONE_BITS)
    s = exp >> 1                             # floor(exp / 2)
    odd = exp - 2 * s
    u = torch.where(odd == 1, man * 2.0, man) * 0.5
    y = taylor.newton_rsqrt(u, seed_ladder(u, table), newton_iters, fma)
    inv_sqrt2 = torch.tensor(np.float32(1.0 / np.sqrt(2.0)), device=x.device)
    return (y * inv_sqrt2) * _f32(torch.clamp(127 - s, 1, 254) << 23)


# The threads of the consumer kernels' row-sum order (kThreads in
# csrc/rows.cuh; the kernels run it on one warp per row, each lane holding
# the partials of 8 of these threads). The row sums below follow that
# order, which is part of the result.
REDUCE_THREADS = 256


def row_sum(v: torch.Tensor, madd=None) -> torch.Tensor:
    """Sum over the last axis in the consumer kernels' fixed order.

    Thread t of ``REDUCE_THREADS`` adds lanes t, t+T, t+2T, ... in sequence
    onto +0; then a halving tree adds partial t+h onto partial t for
    h = T/2, ..., 1. Lanes past the row's end count as +0, which leaves
    every partial unchanged (the summands are never -0 where this is
    used). With ``madd`` the lanes are ``(a, b)`` pairs summed as
    ``acc = madd(a, b, acc)``. Returns the sums with a kept last axis.
    """
    t = REDUCE_THREADS
    a, b = (v, None) if madd is None else v
    d = a.shape[-1]
    pad = -d % t
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
        b = None if b is None else torch.nn.functional.pad(b, (0, pad))
    a = a.reshape(*a.shape[:-1], (d + pad) // t, t)
    b = None if b is None else b.reshape(a.shape)
    acc = torch.zeros(a.shape[:-2] + (t,), dtype=a.dtype, device=a.device)
    for k in range(a.shape[-2]):
        acc = acc + a[..., k, :] if madd is None else madd(a[..., k, :],
                                                             b[..., k, :], acc)
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = acc[..., :h] + acc[..., h:]
    return acc
