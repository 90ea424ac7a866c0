"""Goldschmidt division sharing the paper's PWL seed (the canonical rival).

The PyTorch counterpart of ``src/repro/core/goldschmidt.py``: the
residual-register form N <- N + N*r, r <- r*r, with the first residual from
:func:`taylor.exact_residual`. ``iters_for_terms(n)`` iterations cover the
same series terms as the factored Taylor schedule. :func:`reciprocal_np`
and :func:`divide_np` are the reference's f64 numpy oracles, run in torch
f64 on the CPU with the 53-bit table.
"""
from __future__ import annotations

import math

from . import fpparts
from .seeds import SeedTable, compute_segments
from .taylor import _f64, exact_residual, mul_add, seed_eval

__all__ = ["iters_for_terms", "reciprocal", "divide", "reciprocal_np", "divide_np"]


def iters_for_terms(n_terms: int) -> int:
    """Goldschmidt iterations covering >= n_terms+1 series terms."""
    return max(1, math.ceil(math.log2(n_terms + 1)))


def refine(num0, man_b, y0, iters: int, with_recip: bool = False,
           madd=mul_add):
    """Joint refinement from N = num0 and r = 1 - man_b*y0; ``with_recip``
    rides a 1/man_b accumulator on the same residuals (for the gradient)."""
    r = exact_residual(man_b, y0)
    n = num0
    y = y0
    for _ in range(iters):
        n = madd(n, r, n)        # N * F with F = 1 + r
        if with_recip:
            y = madd(y, r, y)
        r = r * r
    return (n, y) if with_recip else n


def reciprocal(x, table: SeedTable | None = None, *, iters: int = 2,
               underflow: str = "gradual"):
    """Goldschmidt reciprocal. f32 compute; bf16/f16 pass through f32."""
    table = table or compute_segments(2, 24)

    def mantissa_fn(man):
        y0 = seed_eval(man, table)
        return refine(y0, man, y0, iters)

    return fpparts.jnp_reciprocal(
        x, lambda xf: fpparts.bit_reciprocal(xf, mantissa_fn, underflow))


def divide(a, b, table: SeedTable | None = None, *, iters: int = 2,
           underflow: str = "gradual"):
    """Goldschmidt a/b with joint N/D refinement (not a*recip(b))."""
    table = table or compute_segments(2, 24)

    def mantissa_fn(man_a, man_b):
        y0 = seed_eval(man_b, table)
        return refine(man_a * y0, man_b, y0, iters, with_recip=True)

    return fpparts.jnp_divide(
        a, b, lambda af, bf: fpparts.bit_divide(af, bf, mantissa_fn, underflow))


def reciprocal_np(x, table: SeedTable | None = None, *, iters: int = 2):
    """The f64 oracle of the Goldschmidt 1/x (``compute_segments(5, 53)``),
    with the Taylor oracle's frame and edges; a numpy f64 array."""
    table = table or compute_segments(5, 53)

    def mantissa_fn(man):
        y0 = seed_eval(man, table)
        return refine(y0, man, y0, iters)

    return fpparts.recip64(_f64(x), mantissa_fn).numpy()


def divide_np(a, b, table: SeedTable | None = None, *, iters: int = 2):
    """The f64 oracle of the Goldschmidt a/b (joint N/D refinement)."""
    table = table or compute_segments(5, 53)

    def mantissa_fn(man_a, man_b):
        y0 = seed_eval(man_b, table)
        return refine(man_a * y0, man_b, y0, iters, with_recip=True)

    return fpparts.divide64(_f64(a), _f64(b), mantissa_fn).numpy()
