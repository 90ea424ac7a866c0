"""Taylor-series reciprocal / divide / rsqrt on f32 tensors (paper §2-3, §6).

The PyTorch counterpart of the reference's jnp twins (``src/repro/core/
taylor.py``), held bit for bit against them, and of its f64 numpy oracles
(:func:`reciprocal_np`, :func:`divide_np`, :func:`rsqrt_np`): the same
series, seed and Newton code run in torch f64 on the CPU with the 53-bit
tables, returning numpy f64 arrays.

Series schedules for  s = sum_{k=1}^{n'} m^k  (m = 1 - x*y0):

  * ``paper``    — §6 powering unit: odd powers by multiply, even by square;
                   exactly n terms after the leading 1.
  * ``factored`` — prod_{i<j} (1 + m^(2^i)) with j = ceil(log2(n+1)):
                   squarings only, at least n terms.

Every function whose reference twin has a multiply-add takes ``madd``: the
twins pass :func:`fpparts.mul_add` (two roundings, the reference's eager
arithmetic), and the fused kernels' plain versions
(:mod:`repro_torch.kernels.common`) pass an exact fused multiply-add at the
sites where the compiled reference contracts.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import fpparts, powering
from .seeds import SeedTable, compute_segments, rsqrt_seed_table

__all__ = [
    "default_table", "exact_residual", "series_sum", "seed_eval",
    "divide_mantissa", "reciprocal", "divide", "rsqrt", "reciprocal_np",
    "divide_np", "rsqrt_np",
]

mul_add = fpparts.mul_add


def default_table(precision_bits: int = 24, n_iters: int = 2) -> SeedTable:
    """Default seed table: (n, precision) -> segments. f32: n=2, 24 bits."""
    return compute_segments(n_iters, precision_bits)


def exact_residual(man, y0):
    """m = 1 - man*y0 at full product width (two_product, Sterbenz-exact)."""
    p, e = fpparts.two_product(man, y0)
    return (1.0 - p) - e


def _paper_leaves(n: int) -> set:
    """Powers of the §6 schedule that feed no later multiply or square: in
    the compiled reference the sum's add fuses with their product."""
    used = set()
    for kind, src, _ in powering.schedule(n):
        used.update((src,) if kind == "square" else src)
    return set(range(2, n + 1)) - used


def series_sum(m, n: int, schedule: str, madd=mul_add):
    """s = sum_{k=1}^{n'} m^k with n' >= n, without the leading 1."""
    if n <= 0:
        return torch.zeros_like(m)
    if schedule == "factored":
        j = max(1, math.ceil(math.log2(n + 1)))
        s = m
        t = m * m
        for _ in range(j - 1):
            s = madd(t, 1.0 + s, s)   # (1+s)(1+t) = 1 + (s + t*(1+s))
            t = t * t
        return s
    if schedule == "paper":
        powers = powering.eval_powers(m, n, mul=lambda a, b: a * b,
                                      square=lambda a: a * a)
        factors = {dst: ((src, src) if kind == "square" else src)
                   for kind, src, dst in powering.schedule(n)}
        leaves = _paper_leaves(n)
        s = m
        for k in range(2, n + 1):
            if k in leaves:
                a, b = factors[k]
                s = madd(powers[a], powers[b], s)
            else:
                s = s + powers[k]
        return s
    raise ValueError(f"unknown schedule {schedule!r}")


def seed_eval(man, table: SeedTable, madd=mul_add):
    """PWL seed y0(man): segment index by compare-sum, then slope*man + icpt,
    with the table rounded to man's dtype (f32, or f64 for the oracles)."""
    dt = np.float64 if man.dtype == torch.float64 else np.float32
    slopes = torch.tensor(table.slopes.astype(dt), device=man.device)
    intercepts = torch.tensor(table.intercepts.astype(dt), device=man.device)
    inner = torch.tensor(table.inner_boundaries.astype(dt), device=man.device)
    idx = (man[..., None] >= inner).sum(-1)
    return madd(slopes[idx], man, intercepts[idx])


def _reciprocal_mantissa(man, table: SeedTable, n: int, schedule: str,
                        madd=mul_add):
    """1/man for man in [1, 2): PWL seed + Taylor refinement, no edge cases."""
    y0 = seed_eval(man, table, madd)
    return madd(y0, series_sum(exact_residual(man, y0), n, schedule, madd), y0)


def divide_mantissa(man_a, man_b, table: SeedTable, n: int, schedule: str,
                    madd=mul_add):
    """(man_a/man_b, 1/man_b): series reciprocal + Markstein final multiply."""
    rman = _reciprocal_mantissa(man_b, table, n, schedule, madd)
    q_man = fpparts.refine_quotient(man_a * rman, man_a, man_b, rman, madd)
    return q_man, rman


def reciprocal(x, table: SeedTable | None = None, *, n_iters: int | None = None,
               schedule: str = "factored", underflow: str = "gradual"):
    """Taylor-series 1/x. f32 compute; bf16/f16 pass through f32."""
    table = table or default_table()
    n = table.n_iters if n_iters is None else n_iters
    return fpparts.jnp_reciprocal(x, lambda xf: fpparts.bit_reciprocal(
        xf, lambda man: _reciprocal_mantissa(man, table, n, schedule),
        underflow))


def divide(a, b, table: SeedTable | None = None, *, n_iters: int | None = None,
           schedule: str = "factored", underflow: str = "gradual"):
    """Exponent-separated a/b (never a * recip(b))."""
    table = table or default_table()
    n = table.n_iters if n_iters is None else n_iters
    return fpparts.jnp_divide(a, b, lambda af, bf: fpparts.bit_divide(
        af, bf,
        lambda man_a, man_b: divide_mantissa(man_a, man_b, table, n, schedule),
        underflow))


def newton_rsqrt(u, y, newton_iters: int, madd=mul_add):
    """Newton refinement of y ~ rsqrt(u); the last step is compensated.

    Plain steps y <- y*(1.5 - 0.5*u*y^2); the last computes r = 1 - u*y^2
    error-free (two two_products) and applies y <- y + y*(r/2).
    """
    for _ in range(max(newton_iters - 1, 0)):
        y = y * madd(-(0.5 * u * y), y, 1.5)
    if newton_iters > 0:
        hp, he = fpparts.two_product(y, y)
        p2, e2 = fpparts.two_product(u, hp)
        r = madd(-u, he, (1.0 - p2) - e2)
        y = madd(y, 0.5 * r, y)
    return y


def rsqrt_bits(x, table: SeedTable, newton_iters: int, underflow: str):
    """f32 rsqrt body on raw bit fields (subnormal-exact decompose).

    Even/odd exponent split onto u in [0.5, 2), PWL chord seed, Newton, and
    an exact power-of-two recombine (results always land in the normal
    range). ``underflow`` only decides whether subnormal operands are exact
    ("gradual") or the zero class ("ftz", -> signed inf).
    """
    bits = fpparts._bits(x)
    mag = bits & fpparts.F32_MAG_MASK
    sign_bits = bits & fpparts.F32_SIGN
    x_zero = mag < fpparts.F32_IMPLICIT if underflow == "ftz" else mag == 0
    x_inf, x_nan = mag == fpparts.F32_EXP_MASK, mag > fpparts.F32_EXP_MASK
    man, e = fpparts.split_f32(mag)
    man = torch.where(man == 0, 1.0, man)
    ef = e + 1                                   # frexp convention
    s = ef >> 1                                  # floor(ef / 2)
    odd = ef - 2 * s
    u = torch.where(odd == 1, man, man * 0.5)
    y = newton_rsqrt(u, seed_eval(u, table), newton_iters)
    pw = fpparts._f32(torch.clamp(127 - s, 1, 254) << 23)
    r = y * pw
    r = torch.where(x_zero, fpparts._f32(fpparts.F32_EXP_MASK | sign_bits), r)
    r = torch.where(x_inf, 0.0, r)
    neg = (sign_bits != 0) & ~x_zero
    return torch.where(neg | x_nan, torch.nan, r)


def rsqrt(x, table: SeedTable | None = None, *, newton_iters: int = 2,
          underflow: str = "gradual"):
    """Taylor/Newton rsqrt. f32 compute; bf16/f16 pass through f32."""
    table = table or rsqrt_seed_table()
    return fpparts.jnp_rsqrt(
        x, lambda xf: rsqrt_bits(xf, table, newton_iters, underflow))


# ------------------------------------------------------------ f64 oracles

def _f64(x) -> torch.Tensor:
    """An array-like as a CPU f64 tensor (a copy)."""
    return torch.from_numpy(np.array(x, dtype=np.float64))


def reciprocal_np(x, table: SeedTable | None = None, *, n_iters: int | None = None,
                  schedule: str = "paper") -> np.ndarray:
    """The f64 oracle of 1/x on the 53-bit table (``compute_segments(5,
    53)``): the frexp frame and edges of the reference's ``reciprocal_np``
    (0 -> +-inf, inf -> +-0, nan -> nan)."""
    table = table or compute_segments(5, 53)
    n = table.n_iters if n_iters is None else n_iters
    return fpparts.recip64(_f64(x), lambda man: _reciprocal_mantissa(
        man, table, n, schedule)).numpy()


def divide_np(a, b, table: SeedTable | None = None, *, n_iters: int | None = None,
              schedule: str = "paper") -> np.ndarray:
    """The f64 oracle of a/b: exponent-separated, Markstein-corrected."""
    table = table or compute_segments(5, 53)
    n = table.n_iters if n_iters is None else n_iters
    return fpparts.divide64(_f64(a), _f64(b), lambda ma, mb: divide_mantissa(
        ma, mb, table, n, schedule)).numpy()


def rsqrt_np(x, table: SeedTable | None = None, *, newton_iters: int = 3) -> np.ndarray:
    """The f64 oracle of 1/sqrt(x): the even/odd exponent split onto u in
    [0.5, 2), the chord seed, Newton with the compensated last step, and
    the edges of ``jax.lax.rsqrt`` (+-0 -> +-inf, inf -> 0, x < 0 -> nan)."""
    table = table or rsqrt_seed_table()
    x = _f64(x)
    frac, e = torch.frexp(x)
    e = e.to(torch.int64)
    s = e >> 1
    u = fpparts.ldexp64(frac, e - 2 * s)
    r = fpparts.ldexp64(newton_rsqrt(u, seed_eval(u, table), newton_iters), -s)
    inf, nan = torch.tensor(float("inf"), dtype=x.dtype), torch.tensor(float("nan"),
                                                                       dtype=x.dtype)
    r = torch.where(x == 0, torch.copysign(inf, x), r)
    r = torch.where(torch.isinf(x) & (x > 0), torch.zeros((), dtype=x.dtype), r)
    r = torch.where(x < 0, nan, r)
    return torch.where(torch.isnan(x), nan, r).numpy()
