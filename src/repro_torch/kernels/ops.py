"""Shape-generic entry points of the fused division-unit kernels.

The PyTorch counterpart of the tsdiv part of ``src/repro/kernels/ops.py``:
any-rank f32 or bf16 tensors in, the same shape and dtype out, with the
analytic VJPs as :class:`torch.autograd.Function` subclasses (bit casts
carry no gradient). The kernels are elementwise, so every rank takes one
flat launch over contiguous f32: the reference's pad-to-tiles (``_to_2d``)
and its ragged-tile path cannot change the bits, and are not needed.

Which device does the work follows the tensors: CPU tensors run the
kernels' plain versions, CUDA tensors launch the kernels (see
:mod:`.tsdiv`). The mesh-aware dispatch of the reference is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core.fpparts import finite_or_zero
from . import tsdiv

__all__ = ["kernel_applicable", "tsdiv_recip", "tsdiv_divide", "tsdiv_rsqrt"]


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
