"""Shape-generic entry points of the fused division-unit kernels.

The PyTorch counterpart of the tsdiv part of ``src/repro/kernels/ops.py``:
any-rank f32 or bf16 tensors in, the same shape and dtype out, with the
analytic VJPs as :class:`torch.autograd.Function` subclasses (bit casts
carry no gradient). The tsdiv kernels are elementwise, so every rank takes one
flat launch over contiguous f32: the reference's pad-to-tiles (``_to_2d``)
and its ragged-tile path cannot change the bits, and are not needed. The
consumer kernels (:func:`softmax`, :func:`rmsnorm`) take any ``(..., D)`` as
``(M, D)`` rows of any length, so the reference's padding of D to 128 (with
-inf for softmax, 0 for RMSNorm) and of M to 8 is not needed either: a
padded -inf lane adds exactly 0 to a softmax sum, and the RMSNorm kernel
divides by the real D, which is the row's length here.

Which device does the work follows the tensors: CPU tensors run the
kernels' plain versions, CUDA tensors launch the kernels (see
:mod:`.tsdiv`). The mesh-aware dispatch of the reference is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core.fpparts import finite_or_zero
from . import rmsnorm as rmsnorm_k
from . import softmax as softmax_k
from . import tsdiv

__all__ = ["kernel_applicable", "tsdiv_recip", "tsdiv_divide", "tsdiv_rsqrt",
           "softmax", "rmsnorm"]


def kernel_applicable(x: torch.Tensor) -> bool:
    """The kernels take f32 and bf16 tensors with at least one element."""
    return x.dtype in (torch.float32, torch.bfloat16) and x.numel() >= 1


def _flat_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous().reshape(-1)


def _recip_primal(x, n_iters, precision_bits, schedule):
    if x.numel() == 0:
        return 1.0 / x
    y = tsdiv.recip(_flat_f32(x), n_iters, precision_bits, schedule)
    return y.reshape(x.shape).to(x.dtype)


class _Recip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n_iters, precision_bits, schedule):
        r = _recip_primal(x, n_iters, precision_bits, schedule)
        ctx.save_for_backward(r)
        return r

    @staticmethod
    def backward(ctx, g):
        # Edge lanes (r = +-inf at x = 0, including subnormal x under FTZ)
        # get zero gradient, not 0*inf = nan.
        (r,) = ctx.saved_tensors
        rf = finite_or_zero(r)
        return -(g * rf * rf), None, None, None


class _Divide(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, n_iters, precision_bits, schedule):
        if a.numel() == 0:
            q = torch.div(a, b)
        else:
            q = tsdiv.divide(_flat_f32(a), _flat_f32(b), n_iters,
                             precision_bits, schedule)
            q = q.reshape(a.shape).to(a.dtype)
        ctx.save_for_backward(q, b)
        ctx.cfg = (n_iters, precision_bits, schedule)
        return q

    @staticmethod
    def backward(ctx, g):
        # d(a/b) = da/b - q*db/b; 1/b from the reciprocal kernel, as the
        # reference's backward does. Edge lanes get zero gradient.
        q, b = ctx.saved_tensors
        rb = finite_or_zero(_recip_primal(b, *ctx.cfg))
        qf = finite_or_zero(q)
        return g * rb, -(g * qf * rb), None, None, None


def _rsqrt_primal(x, newton_iters, n_segments):
    if x.numel() == 0:
        return torch.rsqrt(x.to(torch.float32)).to(x.dtype)
    y = tsdiv.rsqrt(_flat_f32(x), newton_iters, n_segments)
    return y.reshape(x.shape).to(x.dtype)


class _Rsqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, newton_iters, n_segments):
        r = _rsqrt_primal(x, newton_iters, n_segments)
        ctx.save_for_backward(r)
        return r

    @staticmethod
    def backward(ctx, g):
        # Edge lanes and lanes whose -r^3/2 overflows get zero gradient.
        (r,) = ctx.saved_tensors
        rf = finite_or_zero(r)
        return g * finite_or_zero(-0.5 * rf * rf * rf), None, None


def tsdiv_recip(x: torch.Tensor, n_iters: int = 2, precision_bits: int = 24,
                schedule: str = "factored") -> torch.Tensor:
    """Kernel reciprocal with d(1/x) = -r^2 dx, reusing the kernel's r."""
    return _Recip.apply(x, n_iters, precision_bits, schedule)


def tsdiv_divide(a: torch.Tensor, b: torch.Tensor, n_iters: int = 2,
                 precision_bits: int = 24,
                 schedule: str = "factored") -> torch.Tensor:
    """Fused exponent-separated divide with its analytic VJP.

    Operands must have equal shapes (``division_modes.div`` broadcasts them
    first); the result has ``a``'s dtype.
    """
    if a.shape != b.shape:
        raise ValueError(
            f"tsdiv_divide requires equal shapes, got {tuple(a.shape)} vs "
            f"{tuple(b.shape)}; broadcast the operands first")
    return _Divide.apply(a, b, n_iters, precision_bits, schedule)


def tsdiv_rsqrt(x: torch.Tensor, newton_iters: int = 2,
                n_segments: int = 16) -> torch.Tensor:
    """Fused full-edge rsqrt with d(x^-1/2) = -r^3/2 dx."""
    return _Rsqrt.apply(x, newton_iters, n_segments)


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).contiguous()


class _Softmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n_iters, precision_bits, schedule):
        p = softmax_k.softmax(_rows(x), n_iters, precision_bits, schedule)
        p = p.reshape(x.shape)
        ctx.save_for_backward(p)
        return p

    @staticmethod
    def backward(ctx, g):
        # dx = p * (g - sum(p*g)) on the kernel's own output; fully-masked
        # rows carry p = 0 and nan rows a masked p, so both get 0.
        (p,) = ctx.saved_tensors
        pf = finite_or_zero(p.to(torch.float32))
        gf = g.to(torch.float32)
        dot = torch.sum(pf * gf, dim=-1, keepdim=True)
        return (pf * (gf - dot)).to(p.dtype), None, None, None


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps, newton_iters, n_segments):
        y = rmsnorm_k.rmsnorm(_rows(x), w, eps, newton_iters, n_segments)
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        # r = rsqrt(mean(x^2) + eps): dx = r*w*g - (r^3/D) * x * sum(g*x*w),
        # dw = sum over the batch of g*x*r, as the reference's plain backward.
        x, w = ctx.saved_tensors
        xf, wf, gf = (t.to(torch.float32) for t in (x, w, g))
        d = x.shape[-1]
        r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True)
                        + torch.tensor(ctx.eps, dtype=torch.float32))
        inner = torch.sum(gf * xf * wf, dim=-1, keepdim=True)
        gx = r * wf * gf - (r * r * r / d) * xf * inner
        gw = torch.sum(gf * xf * r, dim=tuple(range(x.dim() - 1)))
        return gx.to(x.dtype), gw.to(w.dtype), None, None, None


def softmax(x: torch.Tensor, n_iters: int = 2, precision_bits: int = 24,
            schedule: str = "factored") -> torch.Tensor:
    """Fused softmax over the last axis of any (..., D) f32/bf16 tensor,
    with the analytic VJP ``dx = p * (g - sum(p*g))``."""
    return _Softmax.apply(x, n_iters, precision_bits, schedule)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            newton_iters: int = 2, n_segments: int = 16) -> torch.Tensor:
    """Fused RMSNorm over the last axis of any (..., D) f32/bf16 tensor,
    with its closed-form VJP for x and w."""
    return _RMSNorm.apply(x, w, eps, newton_iters, n_segments)
