"""Sign/exponent/mantissa bookkeeping of the divide datapath, on int32 views.

The PyTorch counterpart of ``src/repro/core/fpparts.py``. The bit work runs on
``tensor.view(torch.int32)`` because torch has no full ``uint32`` arithmetic,
so three rules hold throughout (the reference works on ``uint32``):

  * the sign mask is written as ``-2**31``;
  * every right shift of a value that may be negative is masked afterwards,
    since ``>>`` on int32 is arithmetic;
  * comparisons are made only on values known to be non-negative.

``underflow="gradual"`` normalizes subnormal operands and rounds underflowing
results into the subnormal lattice exactly; ``"ftz"`` is the fused kernels'
hardware contract (subnormal operands are zeros, subnormal results flush to
signed zero). Everything after the field extraction is integer arithmetic,
so the twins do not depend on how the device treats subnormal floats.

The custom-derivative twins of the reference (``jnp_divide``,
``jnp_reciprocal``, ``jnp_rsqrt``) become :class:`torch.autograd.Function`
subclasses: bit casts carry no gradient, so each op supplies its analytic
derivative, with edge lanes (non-finite results) at zero gradient, never nan.
"""
from __future__ import annotations

import torch

__all__ = [
    "F32_SIGN", "F32_MAG_MASK", "F32_EXP_MASK", "F32_MAN_MASK", "F32_ONE_BITS",
    "F32_IMPLICIT", "UNDERFLOW_POLICIES", "mul_add", "two_product",
    "refine_quotient", "split_f32", "repack_f32", "bit_divide",
    "bit_reciprocal", "finite_or_zero", "jnp_divide", "jnp_reciprocal",
    "jnp_rsqrt", "ldexp64", "recip64", "divide64",
]

# f32 field layout as int32 values (0x8000_0000 does not fit an int32).
F32_SIGN = -(2**31)
F32_MAG_MASK = 0x7FFF_FFFF
F32_EXP_MASK = 0x7F80_0000
F32_MAN_MASK = 0x007F_FFFF
F32_ONE_BITS = 0x3F80_0000
F32_IMPLICIT = 0x0080_0000   # hidden bit / smallest normal's bits

UNDERFLOW_POLICIES = ("gradual", "ftz")

_I32 = torch.int32
_F32 = torch.float32


def _f32(bits: torch.Tensor) -> torch.Tensor:
    return bits.view(_F32)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(_I32)


def mul_add(a, b, c):
    """a*b + c rounded twice, as the reference's eagerly run twins compute it.

    The fused kernels' plain versions pass an exact fused multiply-add in
    its place at the sites where the compiled reference contracts
    (``kernels.common.fma``); the twins never fuse.
    """
    return a * b + c


def two_product(a, b):
    """Error-free product: (p, e) with a*b == p + e exactly.

    Veltkamp split with 2^ceil(prec/2) + 1: 2^12 + 1 for f32, 2^27 + 1 for
    the f64 oracles. The four partial products are exact, so fusing any of
    them into its add would not change ``e``.
    """
    p = a * b
    c = 134217729.0 if a.dtype == torch.float64 else 4097.0
    ta = c * a
    ah = ta - (ta - a)
    al = a - ah
    tb = c * b
    bh = tb - (tb - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _pow2_64(k: torch.Tensor) -> torch.Tensor:
    """2^k as f64 for int64 k in [-1022, 1023], from its bits."""
    return ((k + 1023) << 52).view(torch.float64)


def ldexp64(x: torch.Tensor, k) -> torch.Tensor:
    """x * 2^k on an f64 tensor, rounded once, as numpy's ``ldexp``.

    ``torch.ldexp`` is documented as ``x * 2**k``, whose power of two is inf
    from k = 1024 and 0 below k = -1074 even where x * 2^k is a finite
    nonzero f64 (``ldexp(0.5, 1024)``, ``ldexp(3.0, -1075)``). Here x = f *
    2^ex (``frexp``, f in [0.5, 1)) takes two normal powers of two: the
    first product is exact, the second rounds once (into the subnormal
    lattice, or to inf or 0 past the range).
    """
    f, ex = torch.frexp(x)
    t = ex.to(torch.int64) + torch.as_tensor(k, device=x.device).to(torch.int64)
    a = torch.where(t < -1021, torch.full_like(t, -500), torch.div(t, 2, rounding_mode="floor"))
    a = a.clamp(-1022, 1023)
    return f * _pow2_64(a) * _pow2_64((t - a).clamp(-1022, 1023))


def recip64(x: torch.Tensor, mantissa_fn) -> torch.Tensor:
    """The f64 oracles' reciprocal frame (``src/repro/core/taylor.py``
    ``_reciprocal_impl``, numpy branch): frexp, ``mantissa_fn`` on the
    [1, 2) mantissa, an exact recombine, and the unit's edges: 0 -> +-inf,
    inf -> +-0, nan -> nan."""
    sign = torch.sign(x)
    ax = x.abs()
    frac, e = torch.frexp(ax)
    r = ldexp64(mantissa_fn(frac * 2.0), 1 - e.to(torch.int64)) * sign
    inf = torch.tensor(float("inf"), dtype=x.dtype)
    r = torch.where(ax == 0, torch.copysign(inf, x), r)
    r = torch.where(torch.isinf(ax), torch.copysign(torch.zeros((), dtype=x.dtype), x), r)
    return torch.where(torch.isnan(x), torch.tensor(float("nan"), dtype=x.dtype), r)


def divide64(a: torch.Tensor, b: torch.Tensor, mantissa_fn) -> torch.Tensor:
    """The f64 oracles' exponent-separated divide (``decompose_div``,
    ``recombine_div`` in two ldexp steps, ``div_edges`` of
    ``src/repro/core/fpparts.py``). ``mantissa_fn(man_a, man_b)`` returns
    the quotient's mantissa first."""
    a, b = torch.broadcast_tensors(a, b)
    one = torch.ones((), dtype=a.dtype)
    s = torch.copysign(one, a) * torch.copysign(one, b)
    aa, ab = a.abs(), b.abs()
    fa, ea = torch.frexp(aa)
    fb, eb = torch.frexp(ab)
    q_man = mantissa_fn(fa * 2.0, fb * 2.0)[0]
    de = ea.to(torch.int64) - eb.to(torch.int64)
    h = torch.div(de, 2, rounding_mode="floor")
    q = ldexp64(ldexp64(q_man, h), de - h) * s
    inf, nan = torch.tensor(float("inf"), dtype=a.dtype), torch.tensor(float("nan"),
                                                                       dtype=a.dtype)
    q = torch.where((ab == 0) & (aa != 0), torch.copysign(inf, s), q)
    q = torch.where(torch.isinf(aa) & ~torch.isinf(ab), torch.copysign(inf, s), q)
    q = torch.where(torch.isinf(ab) & ~torch.isinf(aa),
                    torch.copysign(torch.zeros((), dtype=a.dtype), s), q)
    q = torch.where((aa == 0) & (ab == 0), nan, q)
    q = torch.where(torch.isinf(aa) & torch.isinf(ab), nan, q)
    return torch.where(torch.isnan(a) | torch.isnan(b), nan, q)


def refine_quotient(q0, man_a, man_b, rman, madd=mul_add):
    """Markstein correcting step: q = q0 + rman * (man_a - q0*man_b).

    The remainder is exact (two_product, then Sterbenz), so one rounding on
    the small correction lands the quotient within ~1 ulp of man_a/man_b.
    """
    p, e = two_product(q0, man_b)
    res = (man_a - p) - e
    return madd(res, rman, q0)


def split_f32(mag: torch.Tensor):
    """(man in [1, 2), e) with magnitude == man * 2^e, subnormal-exact.

    ``mag`` holds int32 magnitude bits. Subnormals are normalized through an
    exact int->float convert of the mantissa field. Zeros give (0.0, -127);
    infs/nans give (1.mantissa, 128) for the caller's edge overrides.
    """
    expf = mag >> 23                       # mag >= 0: no sign to smear
    manf = mag & F32_MAN_MASK
    mfbits = _bits(manf.to(_F32))          # exact: manf < 2^24
    lead = (mfbits >> 23) - 127
    is_sub = (expf == 0) & (manf != 0)
    man_bits = torch.where(is_sub, (mfbits & F32_MAN_MASK) | F32_ONE_BITS,
                           manf | F32_ONE_BITS)
    e = torch.where(is_sub, lead - 149, expf - 127)
    man = torch.where(mag == 0, 0.0, _f32(man_bits))
    e = torch.where(mag == 0, -127, e)
    return man, e


def repack_f32(man: torch.Tensor, e: torch.Tensor, sign_bits: torch.Tensor,
               underflow: str = "gradual") -> torch.Tensor:
    """Round-to-nearest-even repack of ``sign * man * 2^e`` into f32.

    ``man`` is a normal f32 in (0.5, 4), ``e`` int32. Results below the
    normal range are shifted into the subnormal lattice with RNE; ``"ftz"``
    flushes results still subnormal after rounding; overflow gives inf.
    """
    mbits = _bits(man)
    me = (mbits >> 23) - 127                # man > 0: -1, 0 or +1
    frac = (mbits & F32_MAN_MASK) | F32_IMPLICIT
    et = e + me
    sh = torch.clamp(-126 - et, 0, 31).to(_I32)
    keep = frac >> sh                       # frac >= 0
    low = (1 << sh) - 1                     # wraps to 0x7FFFFFFF at sh = 31
    rem = frac & low
    half = ((low + 1) >> 1) & F32_MAG_MASK  # masked: low + 1 wraps negative
    round_up = ((rem > half) | ((rem == half) & ((keep & 1) == 1))) & (sh > 0)
    sub_bits = keep + round_up.to(_I32)
    norm_bits = ((et + 127) << 23) | (frac & F32_MAN_MASK)
    bits = torch.where(et >= -126, norm_bits, sub_bits)
    if underflow == "ftz":
        bits = torch.where(bits < F32_IMPLICIT, 0, bits)
    bits = torch.where(et > 127, F32_EXP_MASK, bits)
    return _f32(bits | sign_bits)


def bit_divide(a, b, mantissa_fn, underflow: str = "gradual"):
    """Bit-level exponent-separated a/b; returns (q, rb) with rb ~ 1/b.

    ``mantissa_fn(man_a, man_b) -> (q_man, rb_man)`` refines the [1, 2)
    mantissa pair. Classification is by bit tests, and the edge overrides
    run in the order of the fused kernel's divide body.
    """
    abits, bbits = _bits(a), _bits(b)
    mag_a, mag_b = abits & F32_MAG_MASK, bbits & F32_MAG_MASK
    sign_bits = (abits ^ bbits) & F32_SIGN
    if underflow == "ftz":
        a_zero, b_zero = mag_a < F32_IMPLICIT, mag_b < F32_IMPLICIT
    else:
        a_zero, b_zero = mag_a == 0, mag_b == 0
    a_inf, b_inf = mag_a == F32_EXP_MASK, mag_b == F32_EXP_MASK
    a_nan, b_nan = mag_a > F32_EXP_MASK, mag_b > F32_EXP_MASK
    man_a, ea = split_f32(mag_a)
    man_b, eb = split_f32(mag_b)
    man_a = torch.where(man_a == 0, 1.0, man_a)   # keep edge lanes finite;
    man_b = torch.where(man_b == 0, 1.0, man_b)   # the overrides discard them
    q_man, rb_man = mantissa_fn(man_a, man_b)
    q = repack_f32(q_man, ea - eb, sign_bits, underflow)
    inf_s = _f32(F32_EXP_MASK | sign_bits)
    zero_s = _f32(sign_bits)
    q = torch.where(b_zero, inf_s, q)             # x/0   -> signed inf
    q = torch.where(a_zero, zero_s, q)            # 0/y   -> signed 0
    q = torch.where(a_inf, inf_s, q)              # inf/y -> signed inf
    q = torch.where(b_inf, zero_s, q)             # x/inf -> signed 0
    q = torch.where(a_zero & b_zero, torch.nan, q)
    q = torch.where(a_inf & b_inf, torch.nan, q)
    q = torch.where(a_nan | b_nan, torch.nan, q)
    rb = repack_f32(rb_man, -eb, bbits & F32_SIGN, underflow)
    return q, rb


def bit_reciprocal(x, mantissa_fn, underflow: str = "gradual"):
    """Bit-level 1/x; ``mantissa_fn(man) -> rman`` refines 1/man on [1, 2)."""
    bits = _bits(x)
    mag = bits & F32_MAG_MASK
    sign_bits = bits & F32_SIGN
    x_zero = mag < F32_IMPLICIT if underflow == "ftz" else mag == 0
    x_inf, x_nan = mag == F32_EXP_MASK, mag > F32_EXP_MASK
    man, e = split_f32(mag)
    man = torch.where(man == 0, 1.0, man)
    r = repack_f32(mantissa_fn(man), -e, sign_bits, underflow)
    r = torch.where(x_zero, _f32(F32_EXP_MASK | sign_bits), r)
    r = torch.where(x_inf, _f32(sign_bits), r)
    return torch.where(x_nan, torch.nan, r)


def finite_or_zero(t):
    """t with its non-finite lanes set to 0 (the gradients' edge mask)."""
    return torch.where(torch.isfinite(t), t, 0.0)


class _Divide(torch.autograd.Function):
    """q = a/b with dq = rb*da - q*rb*db; edge lanes get zero gradient."""

    @staticmethod
    def forward(ctx, af, bf, impl):
        q, rb = impl(af, bf)
        ctx.save_for_backward(q, rb)
        return q

    @staticmethod
    def backward(ctx, g):
        q, rb = ctx.saved_tensors
        rbm, qm = finite_or_zero(rb), finite_or_zero(q)
        return rbm * g, -(g * (qm * rbm)), None


class _Reciprocal(torch.autograd.Function):
    """r = 1/x with dr = -r^2 dx; edge lanes get zero gradient."""

    @staticmethod
    def forward(ctx, xf, impl):
        r = impl(xf)
        ctx.save_for_backward(r)
        return r

    @staticmethod
    def backward(ctx, g):
        (r,) = ctx.saved_tensors
        rf = finite_or_zero(r)
        return -(rf * rf) * g, None


class _Rsqrt(torch.autograd.Function):
    """r = x^-1/2 with dr = -r^3/2 dx; lanes whose coefficient is not
    finite (edges, or r^3 overflowing for subnormal x) get zero gradient."""

    @staticmethod
    def forward(ctx, xf, impl):
        r = impl(xf)
        ctx.save_for_backward(r)
        return r

    @staticmethod
    def backward(ctx, g):
        (r,) = ctx.saved_tensors
        rf = finite_or_zero(r)
        return finite_or_zero(-0.5 * rf * rf * rf) * g, None


def jnp_divide(a, b, impl):
    """Divide twin wrapper: promote, broadcast, f32 compute, analytic VJP.

    ``impl(af, bf) -> (q, rb)`` is the f32 body. Broadcasting happens
    outside the autograd function, so autograd sums each cotangent back to
    its operand's shape.
    """
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    af, bf = torch.broadcast_tensors(a.to(_F32), b.to(_F32))
    return _Divide.apply(af, bf, impl).to(out_dtype)


def jnp_reciprocal(x, impl):
    """Reciprocal twin wrapper; ``impl(xf) -> r`` is the f32 body."""
    return _Reciprocal.apply(x.to(_F32), impl).to(x.dtype)


def jnp_rsqrt(x, impl):
    """rsqrt twin wrapper; ``impl(xf) -> r`` is the f32 body."""
    return _Rsqrt.apply(x.to(_F32), impl).to(x.dtype)
