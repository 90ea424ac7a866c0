"""Iterative Logarithmic Multiplier (paper §4) and squaring unit (paper §5),
bit-exact on integer mantissas.

The PyTorch counterpart of ``src/repro/core/ilm.py``. ILM (paper eq. 23-27):

    N1*N2 = 2^(k1+k2) + 2^k2*(N1-2^k1) + 2^k1*(N2-2^k2) + (N1-2^k1)(N2-2^k2)

The first three terms are the approximate product; the last is the error,
itself a product of the leading-one-cleared operands, so the unit iterates.
Each iteration clears one leading bit of each operand, so ``iters >=
min(popcount(a), popcount(b))`` gives the exact product. The squarer
iterates N^2 = 4^k + 2^(k+1)*(N-2^k) + (N-2^k)^2 (paper eq. 28).

Two twins, as in the reference: numpy on uint64 lanes (the paper's full
24/53-bit mantissas) and torch with the reference's uint32 lane semantics.
torch has no uint32 arithmetic, so the torch twin works on int64 lanes
masked to 32 bits: every shift and sum is reduced mod 2^32, which gives the
reference's uint32 results, wrap-around included (operands below 2^16 never
wrap). The torch functions take any integer tensor (``torch.uint32``
included, read through an int32 view) and return int64 holding the uint32
value.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "exact_iters_bound", "floor_log2_np", "ilm_mul_np", "ilm_square_np",
    "as_u32_lanes", "floor_log2", "ilm_mul", "ilm_square",
    "fp_mul_ilm_np", "fp_recip_ilm_np",
]

U32 = 0xFFFF_FFFF


def exact_iters_bound(bits: int) -> int:
    """Iterations guaranteeing exactness for operands of this bit width."""
    return bits


# ---------------------------------------------------------------- numpy twin

def floor_log2_np(x: np.ndarray) -> np.ndarray:
    """floor(log2(x)) for x > 0 (the priority encoder). 0 maps to 0."""
    x = np.asarray(x, np.uint64)
    out = np.zeros_like(x, np.int64)
    v = x.copy()
    for s in (32, 16, 8, 4, 2, 1):
        hit = v >= np.uint64(1 << s)
        out = np.where(hit, out + s, out)
        v = np.where(hit, v >> np.uint64(s), v)
    return out


def ilm_mul_np(a, b, iters: int) -> np.ndarray:
    """ILM product with ``iters`` error-correction iterations (numpy, uint64)."""
    a = np.asarray(a, np.uint64)
    b = np.asarray(b, np.uint64)
    acc = np.zeros(np.broadcast(a, b).shape, np.uint64)
    # uint64 wraparound on np.where-discarded lanes is expected; the kept
    # lanes fit 48 bits (24-bit operands) and are exact.
    with np.errstate(over="ignore"):
        for _ in range(iters):
            valid = (a > 0) & (b > 0)
            k1 = floor_log2_np(np.maximum(a, 1)).astype(np.uint64)
            k2 = floor_log2_np(np.maximum(b, 1)).astype(np.uint64)
            ra = a - (np.uint64(1) << k1)      # LOD residue: N1 - 2^k1
            rb = b - (np.uint64(1) << k2)
            p = (np.uint64(1) << (k1 + k2)) + (ra << k2) + (rb << k1)
            acc = np.where(valid, acc + p, acc)
            a = np.where(valid, ra, a)
            b = np.where(valid, rb, b)
    return acc


def ilm_square_np(a, iters: int) -> np.ndarray:
    """Squaring unit: iterates N^2 = 4^k + 2^(k+1)(N-2^k) + (N-2^k)^2."""
    a = np.asarray(a, np.uint64)
    acc = np.zeros_like(a)
    for _ in range(iters):
        valid = a > 0
        k = floor_log2_np(np.maximum(a, 1)).astype(np.uint64)
        r = a - (np.uint64(1) << k)
        p = (np.uint64(1) << (np.uint64(2) * k)) + (r << (k + np.uint64(1)))
        acc = np.where(valid, acc + p, acc)
        a = np.where(valid, r, a)
    return acc


# ---------------------------------------------------------------- torch twin

def as_u32_lanes(x: torch.Tensor) -> torch.Tensor:
    """An integer tensor as int64 lanes holding its uint32 value (x mod 2^32)."""
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    return x.to(torch.int64) & U32


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """Population count of int64 lanes below 2^32 (SWAR)."""
    v = v - ((v >> 1) & 0x5555_5555)
    v = (v & 0x3333_3333) + ((v >> 2) & 0x3333_3333)
    v = (v + (v >> 4)) & 0x0F0F_0F0F
    return ((v * 0x0101_0101) & U32) >> 24


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) on uint32 lanes via bit-smear + population count
    (0 gives -1)."""
    v = as_u32_lanes(x)
    for s in (1, 2, 4, 8, 16):
        v = v | (v >> s)
    return _popcount32(v) - 1


def _shl(v: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """uint32 ``v << k``: 0 for shifts of 32 or more, as the reference's."""
    return (v << k) & U32


def ilm_mul(a: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """ILM product on uint32 lanes. Operands must be < 2^16 for exact headroom."""
    a, b = torch.broadcast_tensors(as_u32_lanes(a), as_u32_lanes(b))
    acc = torch.zeros_like(a)
    one = torch.ones_like(a)
    for _ in range(iters):
        valid = (a > 0) & (b > 0)
        k1 = floor_log2(torch.clamp(a, min=1)).clamp(min=0)
        k2 = floor_log2(torch.clamp(b, min=1)).clamp(min=0)
        ra = (a - _shl(one, k1)) & U32
        rb = (b - _shl(one, k2)) & U32
        p = (_shl(one, k1 + k2) + _shl(ra, k2) + _shl(rb, k1)) & U32
        acc = torch.where(valid, (acc + p) & U32, acc)
        a = torch.where(valid, ra, a)
        b = torch.where(valid, rb, b)
    return acc


def ilm_square(a: torch.Tensor, iters: int) -> torch.Tensor:
    """Squaring unit on uint32 lanes. Operand < 2^16."""
    a = as_u32_lanes(a)
    acc = torch.zeros_like(a)
    one = torch.ones_like(a)
    for _ in range(iters):
        valid = a > 0
        k = floor_log2(torch.clamp(a, min=1)).clamp(min=0)
        r = (a - _shl(one, k)) & U32
        p = (_shl(one, k + k) + _shl(r, k + 1)) & U32
        acc = torch.where(valid, (acc + p) & U32, acc)
        a = torch.where(valid, r, a)
    return acc


# ------------------------------------- floating-point emulation (numpy oracle)

def fp_mul_ilm_np(x, y, *, iters: int, mant_bits: int = 24) -> np.ndarray:
    """FP multiply through the ILM on quantized mantissas (hardware emulation)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    fx, ex = np.frexp(np.abs(x))
    fy, ey = np.frexp(np.abs(y))
    scale = 1 << (mant_bits - 1)
    mx = np.round(fx * 2 * scale).astype(np.uint64)   # in [2^(mb-1), 2^mb]
    my = np.round(fy * 2 * scale).astype(np.uint64)
    p = ilm_mul_np(mx, my, iters).astype(np.float64)
    r = np.ldexp(p / (4.0 * scale * scale), (ex - 1) + (ey - 1) + 2)
    return r * np.sign(x) * np.sign(y)


def fp_recip_ilm_np(x, *, table=None, iters_mul: int = 24, n_terms: int = 5) -> np.ndarray:
    """Full §7 system emulation: PWL seed + Taylor series, all multiplies via ILM.

    The bit-faithful model of the paper's Fig. 7 datapath: the powering unit
    evaluates the series with the ILM multiplier/squarer; the final a*b^-1
    multiply also goes through the ILM.
    """
    from . import powering
    from .seeds import compute_segments

    table = table or compute_segments(5, 53)
    x = np.asarray(x, np.float64)
    frac, e = np.frexp(np.abs(x))
    man = frac * 2.0
    y0 = table.seed(man)
    mul = lambda a, b: fp_mul_ilm_np(a, b, iters=iters_mul)
    m = 1.0 - mul(man, y0)
    powers = powering.eval_powers(
        m, n_terms, mul=mul,
        square=lambda a: fp_mul_ilm_np(a, a, iters=iters_mul))
    acc = np.ones_like(m) + (m if n_terms >= 1 else 0.0)
    for k in range(2, n_terms + 1):
        acc = acc + powers[k]
    rman = mul(y0, acc)
    return np.ldexp(rman, 1 - e) * np.sign(x)
