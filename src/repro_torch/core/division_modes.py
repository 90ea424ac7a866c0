"""Division dispatch: the paper's unit as one config knob.

The PyTorch counterpart of ``src/repro/core/division_modes.py``: the scalar
ops :func:`recip`, :func:`div` and :func:`rsqrt` and their consumers
:func:`softmax`, :func:`rmsnorm` and :func:`attention`. Modes:

  * ``exact``              — torch's own divide / rsqrt (the baseline).
  * ``taylor``             — the paper's unit as torch ops (PWL seed + series).
  * ``taylor_pallas``      — the fused kernel: the hand-written CUDA kernel
                             for a CUDA tensor, its plain version for a CPU
                             tensor (the name is kept so configs round-trip).
  * ``goldschmidt``        — Goldschmidt N/D refinement on the same seed ROM.
  * ``goldschmidt_pallas`` — the same refinement in the fused kernel.
  * ``ilm``                — every multiply of the reciprocal and rsqrt
                             datapaths through the 16-bit Iterative
                             Logarithmic Multiplier (``core/ilm.py``) on
                             12-bit mantissas: the ~12-bit end of the dial.

The consumers route every mode the same way: the kernel modes to the fused
softmax, RMSNorm and flash-attention kernels, every other mode to twins
whose divisions call back into this module. A CUDA tensor in a ``*_pallas``
mode launches the kernel or raises; nothing falls back to another path or
to the CPU.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import fpparts, goldschmidt, ilm, powering, taylor
from .fpparts import UNDERFLOW_POLICIES
from .seeds import compute_segments, rsqrt_seed_table

__all__ = ["MODES", "DivisionConfig", "EXACT", "TAYLOR", "effective_underflow",
           "recip", "div", "rsqrt", "softmax", "split_softmax", "rmsnorm", "attention"]

MODES = ("exact", "taylor", "taylor_pallas", "goldschmidt",
         "goldschmidt_pallas", "ilm")
_KERNEL_MODES = ("taylor_pallas", "goldschmidt_pallas")
_TINY = 2.0 ** -126


@dataclasses.dataclass(frozen=True)
class DivisionConfig:
    """Precision dial per paper eq. 17: (n_iters, precision_bits) -> segments.

    Same fields, defaults and validation as the reference's config, so a
    config round-trips through ``dataclasses.asdict``.
    """

    mode: str = "taylor"
    precision_bits: int = 24
    n_iters: int = 2
    schedule: str = "factored"    # 'paper' | 'factored'
    rsqrt_newton: int = 2
    rsqrt_segments: int = 16
    underflow: str = "gradual"    # subnormal policy of the twins

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r} not in {MODES}")
        if self.underflow not in UNDERFLOW_POLICIES:
            raise ValueError(
                f"underflow {self.underflow!r} not in {UNDERFLOW_POLICIES}")

    @property
    def table(self):
        return compute_segments(self.n_iters, self.precision_bits)

    @property
    def rtable(self):
        return rsqrt_seed_table(self.rsqrt_segments)

    @property
    def gs_iters(self) -> int:
        """Goldschmidt iterations matching this n_iters' covered terms."""
        return goldschmidt.iters_for_terms(self.n_iters)


EXACT = DivisionConfig(mode="exact")
TAYLOR = DivisionConfig(mode="taylor")


def effective_underflow(cfg: DivisionConfig) -> str:
    """The subnormal policy a config actually delivers.

    The twins honor ``cfg.underflow``; the fused kernels and ILM flush by
    design. ``exact`` is torch's own arithmetic, which keeps subnormals on
    the CPU and on CUDA ("gradual"; the reference reports "ftz" because
    XLA on the CPU flushes).
    """
    if cfg.mode in ("taylor", "goldschmidt"):
        return cfg.underflow
    return "gradual" if cfg.mode == "exact" else "ftz"


def _kernel_schedule(cfg: DivisionConfig) -> str:
    return cfg.schedule if cfg.mode == "taylor_pallas" else "goldschmidt"


def _takes_kernel(*ts: torch.Tensor) -> bool:
    """Whether a ``*_pallas`` config runs the fused kernel on these tensors.

    Empty tensors and dtypes the kernel lacks run the twin on the CPU, as
    in the reference; on a CUDA tensor a dtype the kernel lacks raises.
    """
    from repro_torch.kernels import ops as kops

    if all(kops.kernel_applicable(t) for t in ts):
        return True
    if any(t.is_cuda and t.numel() for t in ts):
        raise TypeError(f"the fused division kernels take float32 or bfloat16 "
                        f"CUDA tensors, got {[t.dtype for t in ts]}")
    return False


def _as_tensor(v, like: torch.Tensor) -> torch.Tensor:
    if torch.is_tensor(v):
        return v
    dtype = like.dtype if like.is_floating_point() else torch.float32
    return torch.as_tensor(v, dtype=dtype, device=like.device)


def recip(x: torch.Tensor, cfg: DivisionConfig = TAYLOR) -> torch.Tensor:
    """1/x through the mode the config names."""
    if cfg.mode == "exact":
        return 1.0 / x
    if cfg.mode == "ilm":
        return _recip_ilm(x, cfg)
    if cfg.mode in _KERNEL_MODES and _takes_kernel(x):
        from repro_torch.kernels import ops as kops

        return kops.tsdiv_recip(x, cfg.n_iters, cfg.precision_bits,
                                _kernel_schedule(cfg))
    if cfg.mode in ("taylor", "taylor_pallas"):
        return taylor.reciprocal(x, cfg.table, schedule=cfg.schedule,
                                 underflow=effective_underflow(cfg))
    return goldschmidt.reciprocal(x, cfg.table, iters=cfg.gs_iters,
                                  underflow=effective_underflow(cfg))


def div(a, b, cfg: DivisionConfig = TAYLOR) -> torch.Tensor:
    """a/b through the exponent-separated datapath (never a * recip(b)).

    Operands broadcast; mixed dtypes promote. The kernel modes materialise
    the broadcast, since the kernel takes equal contiguous operands.
    ``ilm`` keeps the bit-faithful ``a * recip(b)`` emulation, whose
    under/overflow is part of what it emulates, with the IEEE edge contract
    applied on top (FTZ: subnormal operands are zeros, subnormal quotients
    flush).
    """
    if not torch.is_tensor(a):
        a = _as_tensor(a, b)
    b = _as_tensor(b, a)
    if cfg.mode == "exact":
        return a / b
    if cfg.mode == "ilm":
        return _div_ilm(a, b, cfg)
    if cfg.mode in _KERNEL_MODES:
        ct = torch.promote_types(a.dtype, b.dtype)
        ab, bb = torch.broadcast_tensors(a.to(ct), b.to(ct))
        if _takes_kernel(ab, bb):
            from repro_torch.kernels import ops as kops

            return kops.tsdiv_divide(ab, bb, cfg.n_iters, cfg.precision_bits,
                                     _kernel_schedule(cfg))
    if cfg.mode in ("goldschmidt", "goldschmidt_pallas"):
        return goldschmidt.divide(a, b, cfg.table, iters=cfg.gs_iters,
                                  underflow=effective_underflow(cfg))
    return taylor.divide(a, b, cfg.table, schedule=cfg.schedule,
                         underflow=effective_underflow(cfg))


def rsqrt(x: torch.Tensor, cfg: DivisionConfig = TAYLOR) -> torch.Tensor:
    """1/sqrt(x) through the mode the config names.

    The rsqrt dial is ``rsqrt_newton``, so taylor and goldschmidt share one
    body, as in the reference.
    """
    if cfg.mode == "exact":
        return torch.rsqrt(x)
    if cfg.mode == "ilm":
        return _rsqrt_ilm(x, cfg)
    if cfg.mode in _KERNEL_MODES and _takes_kernel(x):
        from repro_torch.kernels import ops as kops

        return kops.tsdiv_rsqrt(x, cfg.rsqrt_newton, cfg.rsqrt_segments)
    return taylor.rsqrt(x, cfg.rtable, newton_iters=cfg.rsqrt_newton,
                        underflow=effective_underflow(cfg))


def softmax(x: torch.Tensor, axis: int = -1, cfg: DivisionConfig = TAYLOR,
            where=None) -> torch.Tensor:
    """Numerically stable softmax whose 1/sum goes through the division unit.

    The kernel modes run the fused softmax kernel (``kernels.ops.softmax``;
    ``schedule="goldschmidt"`` for ``goldschmidt_pallas``) on f32/bf16
    operands with at least one element; other operands take the twin below,
    whose f32 1/sum still goes through :func:`recip` under the same config.
    On a CUDA tensor of another dtype a kernel mode raises. ``where`` masks
    logits out (as -inf for the kernel). Fully-masked rows (``where``
    all False, or every logit -inf) come out as zeros in every mode.
    """
    if x.dim() == 0:
        return torch.ones_like(x)    # a single logit normalises to 1
    if x.shape[axis] == 0:
        return x                     # no logits: empty in, empty out
    if where is not None:
        where = torch.as_tensor(where, device=x.device)
    if cfg.mode in _KERNEL_MODES and _takes_kernel(x):
        from repro_torch.kernels import ops as kops

        xm = x if where is None else torch.where(where, x, -torch.inf)
        out = kops.softmax(xm.movedim(axis, -1), cfg.n_iters,
                           cfg.precision_bits, _kernel_schedule(cfg))
        return out.movedim(-1, axis)
    # f32 compute with the input dtype back out, like the kernel; the row sum
    # runs in the kernel's order, so the modes share every exp and sum
    # rounding and differ only in the division (the reference's twins and
    # kernels share XLA's order in the same way).
    from repro_torch.kernels.common import row_sum

    xf = x.to(torch.float32)
    if where is not None:
        xf, where = torch.broadcast_tensors(xf, where)
        where = where.movedim(axis, -1)
    xf = xf.movedim(axis, -1)
    xs = xf if where is None else torch.where(where, xf, -torch.inf)
    xmax = torch.amax(xs, dim=-1, keepdim=True)
    xmax = torch.where(torch.isfinite(xmax), xmax, 0.0)
    ex = torch.exp(xf - xmax.detach())
    if where is not None:
        ex = torch.where(where, ex, 0.0)
    s = row_sum(ex)
    # Fully-masked rows have ex == 0 lane-wise, so a divisor of 1 yields the
    # zero row exactly; rows with any surviving logit have s >= 1.
    safe = torch.where(s == 0, torch.ones_like(s), s)
    out = ex / safe if cfg.mode == "exact" else ex * recip(safe, cfg)
    return out.movedim(-1, axis).to(x.dtype)


def split_softmax(x: torch.Tensor, cfg: DivisionConfig, max_over, sum_over) -> torch.Tensor:
    """:func:`softmax` over the last axis of f32 rows split over ranks:
    ``x`` (..., D) is this rank's block of each row, masked lanes -inf.
    ``max_over`` / ``sum_over`` combine a (rows, 1) partial over the ranks
    (the all-reduces): the rows' maxima (exact), then the sums of
    ``exp(x - max)`` in the kernels' order, so only the sums' order
    differs from the whole row's. The kernel modes run the split softmax
    kernel's three passes (``kernels.softmax_split``), the other modes
    their plain versions with the 1/sum through :func:`recip`. Rows masked
    on every rank come out as zeros. No autograd."""
    from repro_torch.kernels import softmax_split as ks

    rows = x.reshape(-1, x.shape[-1]).contiguous()
    kernel = cfg.mode in _KERNEL_MODES and _takes_kernel(rows)
    top = max_over(ks.split_max(rows) if kernel else ks.split_max_plain(rows))
    ex, s = ks.split_exp(rows, top) if kernel else ks.split_exp_plain(rows, top)
    total = sum_over(s)
    if kernel:
        out = ks.split_scale(ex, total, cfg.n_iters, cfg.precision_bits, _kernel_schedule(cfg))
    else:
        safe = torch.where(total == 0, torch.ones_like(total), total)
        out = ex / safe if cfg.mode == "exact" else ex * recip(safe, cfg)
    return out.reshape(x.shape)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, cfg: DivisionConfig = TAYLOR, *,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis; the 1/sqrt runs the configured mode.

    The kernel modes run the fused RMSNorm kernel (``kernels.ops.rmsnorm``)
    on f32/bf16 operands with at least one element; every other mode runs
    the twin with the rsqrt through :func:`rsqrt` (``torch.rsqrt`` for
    ``exact``); its mean of squares sums in the kernel's order. f32
    compute, the input dtype back out.
    """
    if x.dim() == 0 or x.shape[-1] == 0:
        return x
    if cfg.mode in _KERNEL_MODES and _takes_kernel(x):
        from repro_torch.kernels import ops as kops

        return kops.rmsnorm(x, w, eps, cfg.rsqrt_newton, cfg.rsqrt_segments)
    from repro_torch.kernels.common import row_sum

    xf = x.to(torch.float32)
    se = row_sum(xf * xf) / x.shape[-1] + torch.tensor(eps, dtype=torch.float32)
    r = torch.rsqrt(se) if cfg.mode == "exact" else rsqrt(se, cfg)
    return (xf * r * w.to(torch.float32)).to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              cfg: DivisionConfig = TAYLOR, *, causal: bool = True) -> torch.Tensor:
    """Scaled dot-product attention with the softmax 1/l through the unit.

    q/k/v: (..., S, hd). The kernel modes run the fused flash-attention
    kernel (``kernels.ops.flash_attention``: online softmax with the final
    1/l in the division unit, ``schedule="goldschmidt"`` for
    ``goldschmidt_pallas``; ragged lengths by pad-and-mask) on f32/bf16
    operands with at least one element. Every other mode runs the twin: f32
    scores times f32(1/sqrt(hd)), the causal mask at the kernel's
    ``NEG_INF``, :func:`softmax` under the same config, then ``p @ v``.
    """
    if cfg.mode in _KERNEL_MODES and _takes_kernel(q, k, v):
        from repro_torch.kernels import ops as kops

        return kops.flash_attention(q, k, v, causal, n_iters=cfg.n_iters,
                                    precision_bits=cfg.precision_bits,
                                    schedule=_kernel_schedule(cfg))
    # One causal-mask sentinel for the twin and the fused kernel.
    from repro_torch.kernels.flash_attention import NEG_INF, causal_mask

    scale = torch.tensor(np.float32(1.0 / math.sqrt(q.shape[-1])), device=q.device)
    s = torch.einsum("...qh,...kh->...qk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if causal:
        s = torch.where(causal_mask(*s.shape[-2:], q.device), s, NEG_INF)
    p = softmax(s, -1, cfg)
    return torch.einsum("...qk,...kh->...qh", p, v.to(torch.float32)).to(q.dtype)


# ---------------------------------------------------------------- ILM modes
#
# The reference runs these datapaths eagerly on XLA's CPU backend, which
# flushes subnormal results and reads subnormal operands as zeros (F4), and
# builds them from jnp.frexp / jnp.ldexp. The helpers below give those
# functions' values on the lanes the datapaths use, with the flush explicit:
# torch keeps subnormals, and torch.ldexp computes x * 2**e, whose 2**e
# overflows where the result is finite.

def _frexp_ftz(x: torch.Tensor):
    """jnp.frexp of f32 x under XLA's flush: (frac in [0.5, 1), e) with
    x == frac * 2^e for normal x; (x, 0) for zeros, subnormals, infs, nans."""
    bits = x.contiguous().view(torch.int32)
    exp = (bits >> 23) & 0xFF
    normal = (exp != 0) & (exp != 255)
    frac = ((bits & ~fpparts.F32_EXP_MASK) | (126 << 23)).view(torch.float32)
    return torch.where(normal, frac, x), torch.where(normal, exp - 126, 0)


def _ldexp_ftz(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """jnp.ldexp of f32 x under XLA's flush: x * 2^e rounded once (exact in
    f64), subnormal results to signed zero, overflow to inf."""
    p2 = ((e.to(torch.int64).clamp(-1022, 1023) + 1023) << 52).view(torch.float64)
    r = (x.to(torch.float64) * p2).to(torch.float32)
    return torch.where(r.abs() < _TINY, r * 0.0, r)


def _sign(x: torch.Tensor) -> torch.Tensor:
    """jnp.sign: +-1, signed zeros and nans kept (torch.sign gives +0 for -0)."""
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x))


def _ilm_fpmul(mant_bits: int = 12, iters: int = 12):
    """Float multiply with the mantissa product through the 16-bit ILM.

    Mantissas are quantized to ``mant_bits`` (round half to even) so ILM
    products fit uint32 lanes; the result carries ~12-bit precision.
    """
    scale = 1 << (mant_bits - 1)

    def fpmul(a, b):
        fa, ea = _frexp_ftz(a.abs())
        fb, eb = _frexp_ftz(b.abs())
        ma = torch.round(fa * 2 * scale).to(torch.int64)
        mb = torch.round(fb * 2 * scale).to(torch.int64)
        p = ilm.ilm_mul(ma, mb, iters).to(torch.float32)
        r = _ldexp_ftz(p / (4.0 * scale * scale), (ea - 1) + (eb - 1) + 2)
        return r * _sign(a) * _sign(b)

    return fpmul


class _IlmRecip(torch.autograd.Function):
    """r = 1/x with the rule of the reference's ``taylor.attach_grad``:
    dr = -r^2 dx, zero where -r^2 or x is not finite."""

    @staticmethod
    def forward(ctx, xf, impl):
        r = impl(xf)
        ctx.save_for_backward(xf, r)
        return r

    @staticmethod
    def backward(ctx, g):
        xf, r = ctx.saved_tensors
        coef = torch.where(torch.isfinite(xf), fpparts.finite_or_zero(-(r * r)), 0.0)
        return coef * g, None


def _recip_ilm(x: torch.Tensor, cfg: DivisionConfig) -> torch.Tensor:
    """Reciprocal with every multiply through the 16-bit ILM (FTZ)."""
    table = compute_segments(min(cfg.n_iters, 5), min(cfg.precision_bits, 12))
    fpmul = _ilm_fpmul()

    def impl(xf):
        frac, e = _frexp_ftz(xf.abs())
        man = frac * 2.0
        y0 = taylor.seed_eval(man, table)
        m = 1.0 - fpmul(man, y0)
        powers = powering.eval_powers(m, table.n_iters, mul=fpmul,
                                      square=lambda a: fpmul(a, a))
        acc = torch.ones_like(m) + m
        for k in range(2, table.n_iters + 1):
            acc = acc + powers[k]
        r = _ldexp_ftz(fpmul(y0, acc), 1 - e) * _sign(xf)
        # The edge contract of every mode, with subnormals in the zero class:
        # +-0 -> +-inf, +-inf -> +-0, nan -> nan.
        r = torch.where(xf.abs() < _TINY, torch.copysign(torch.full_like(xf, math.inf), xf), r)
        r = torch.where(torch.isinf(xf), torch.copysign(torch.zeros_like(xf), xf), r)
        return torch.where(torch.isnan(xf), math.nan, r)

    return _IlmRecip.apply(x.to(torch.float32), impl).to(x.dtype)


def _rsqrt_ilm(x: torch.Tensor, cfg: DivisionConfig) -> torch.Tensor:
    """rsqrt with every Newton multiply through the 16-bit ILM: the PWL chord
    seed of ``cfg.rtable`` on the parity-folded mantissa, then
    ``cfg.rsqrt_newton`` steps whose y*y, u*y^2 and correction products all
    run the ILM. FTZ (subnormal operands are the zero class); +-0 -> +-inf,
    +inf -> +0, x < 0 and nan -> nan; gradients by the shared rsqrt rule."""
    fpmul = _ilm_fpmul()

    def impl(xf):
        ax = xf.abs()
        frac, e = _frexp_ftz(ax)
        s = e >> 1
        u = _ldexp_ftz(frac, e - 2 * s)           # in [0.5, 2)
        y = taylor.seed_eval(u, cfg.rtable)
        for _ in range(cfg.rsqrt_newton):
            t = fpmul(u, fpmul(y, y))
            y = fpmul(y, 1.5 - 0.5 * t)
        r = _ldexp_ftz(y, -s)
        tiny = ax < _TINY
        r = torch.where(tiny, torch.copysign(torch.full_like(xf, math.inf), xf), r)
        r = torch.where(torch.isinf(xf) & (xf > 0), 0.0, r)
        neg = (xf < 0) & ~tiny
        return torch.where(neg | torch.isnan(xf), math.nan, r)

    return fpparts.jnp_rsqrt(x, impl)


def _div_ilm(a: torch.Tensor, b: torch.Tensor, cfg: DivisionConfig) -> torch.Tensor:
    """a * recip(b) in the ILM mode, then the IEEE special-value contract
    (the composed multiply turns inf * 0 into nan where IEEE wants inf)."""
    a, b = torch.broadcast_tensors(a, b)
    a_zero, b_zero = a.abs() < _TINY, b.abs() < _TINY      # FTZ zero class
    r = recip(b, cfg)
    # The product in f32 (as XLA multiplies bf16), flushed before rounding
    # to the result type.
    q = torch.where(a_zero, a * 0.0, a).to(torch.float32) * r.to(torch.float32)
    q = torch.where(q.abs() < _TINY, q * 0.0, q).to(torch.promote_types(a.dtype, r.dtype))
    s = torch.copysign(torch.ones_like(q), a) * torch.copysign(torch.ones_like(q), b)
    a_inf, b_inf = torch.isinf(a), torch.isinf(b)
    q = torch.where(b_zero & ~a_zero, torch.copysign(torch.full_like(q, math.inf), s), q)
    q = torch.where(a_inf & ~b_inf, torch.copysign(torch.full_like(q, math.inf), s), q)
    q = torch.where(b_inf & ~a_inf, torch.copysign(torch.zeros_like(q), s), q)
    q = torch.where((a_zero & b_zero) | (a_inf & b_inf), math.nan, q)
    return torch.where(torch.isnan(a) | torch.isnan(b), math.nan, q)
