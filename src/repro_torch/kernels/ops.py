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

:func:`flash_attention` takes ``(..., S, hd)`` q/k/v with leading dims
flattened onto the kernel's batch-heads axis, and pads ragged lengths as the
reference's wrapper does: q up to a ``block_q`` multiple (the padded rows
are sliced off), k/v up to a ``block_k`` multiple with the padded keys
masked in the kernel (``sk_real``). Its backward recomputes the score
matrix in plain torch, as the reference's does. :func:`ilm_mul` and
:func:`ilm_square` take integer tensors of any shape as uint32 lanes and
return ``torch.uint32``.

Which device does the work follows the tensors: CPU tensors run the
kernels' plain versions, CUDA tensors launch the kernels (see
:mod:`.tsdiv`).

Mesh dispatch (the reference's ``_row_shard_axes`` / ``_shard_rows``): a
``DTensor`` plays the part of a sharded global ``jax.Array``. When
:func:`tsdiv_recip`, :func:`tsdiv_divide` or :func:`tsdiv_rsqrt` gets a rank
>= 2 DTensor on the active mesh (``sharding.rules.use_mesh``) whose dim 0
is split over the mesh's batch axes (``rules.batch_partition`` of that
dim's size: the largest divisible prefix of ('pod', 'data')) and that is
replicated over every other mesh axis, each rank launches the kernel once
on its own block (``to_local()``, viewed as (rows/n, N)) and the result is
rewrapped with the same placements: no collective, and the bits of the
unsharded launch. The analytic VJPs run on each block. Any other DTensor
raises ValueError, naming its placements and mesh: it is never gathered
(``full_tensor()``), which would be the silent all-gather the reference's
dispatch exists to avoid. A plain tensor is the rank's own tensor and
takes its one launch, mesh or not; ``rules.suspend_mesh()`` hides the mesh
inside the sharded workloads, which divide plain blocks.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.fpparts import finite_or_zero
from repro_torch.core.ilm import as_u32_lanes
from . import flash_attention as flash_k
from . import ilm as ilm_k
from . import rmsnorm as rmsnorm_k
from . import softmax as softmax_k
from . import tsdiv

__all__ = ["kernel_applicable", "tsdiv_recip", "tsdiv_divide", "tsdiv_rsqrt",
           "softmax", "rmsnorm", "flash_padded", "flash_attention", "ilm_mul",
           "ilm_square"]


def kernel_applicable(x: torch.Tensor) -> bool:
    """The kernels take f32 and bf16 tensors with at least one element."""
    return x.dtype in (torch.float32, torch.bfloat16) and x.numel() >= 1


def _is_dtensor(t) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _where(t) -> str:
    if _is_dtensor(t):
        return f"placements {tuple(t.placements)} on {t.device_mesh}"
    return "a plain tensor"


def _on_blocks(name: str, fn, *operands):
    """``fn`` on each rank's own block of DTensor ``operands`` (dim 0 split
    over the batch axes, every other mesh axis replicated), rewrapped with
    their placements; raises ValueError for any other placement."""
    from torch.distributed.tensor import DTensor
    from repro_torch.sharding import rules as shr

    x = operands[0]
    mesh, pl = x.device_mesh, tuple(x.placements)
    for t in operands[1:]:
        if not _is_dtensor(t) or t.device_mesh != mesh or tuple(t.placements) != pl:
            raise ValueError(f"{name}: the operands are placed differently ({_where(x)} "
                             f"vs {_where(t)}); redistribute them first")
    axes = shr.batch_partition(mesh, x.shape[0]) if x.ndim >= 2 else ()
    want = shr.batch_sharding(mesh, axes, x.ndim).placements if axes else None
    active = shr.active_mesh()
    if (active != mesh or shr.axes_size(mesh, axes) <= 1
            or not shr.same_placements(mesh, pl, want)):
        why = ("no active mesh: register it with sharding.rules.use_mesh" if active is None
               else "the active mesh is another" if active != mesh
               else "a rank >= 2 tensor with dim 0 split over the batch axes "
                    f"{axes or ''} and replicated elsewhere is wanted")
        raise ValueError(f"{name}: cannot launch on a DTensor of shape {tuple(x.shape)} "
                         f"with {_where(x)}: {why}. It is not gathered.")
    out = fn(*(t.to_local() for t in operands))
    return DTensor.from_local(out, mesh, pl, run_check=False)


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
    if _is_dtensor(x):
        return _on_blocks("tsdiv_recip", lambda xl: _Recip.apply(
            xl, n_iters, precision_bits, schedule), x)
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
    if _is_dtensor(a) or _is_dtensor(b):
        if not _is_dtensor(a):
            raise ValueError(f"tsdiv_divide: the operands are placed differently "
                             f"({_where(a)} vs {_where(b)}); redistribute them first")
        return _on_blocks("tsdiv_divide", lambda al, bl: _Divide.apply(
            al, bl, n_iters, precision_bits, schedule), a, b)
    return _Divide.apply(a, b, n_iters, precision_bits, schedule)


def tsdiv_rsqrt(x: torch.Tensor, newton_iters: int = 2,
                n_segments: int = 16) -> torch.Tensor:
    """Fused full-edge rsqrt with d(x^-1/2) = -r^3/2 dx."""
    if _is_dtensor(x):
        return _on_blocks("tsdiv_rsqrt", lambda xl: _Rsqrt.apply(xl, newton_iters, n_segments), x)
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
        # The kernel reads an f32 or bf16 weight as it is; any other weight
        # is cast to f32 first, as the reference's kernel casts it.
        wk = w if rmsnorm_k.takes_weight(w) else w.to(torch.float32).contiguous()
        y = rmsnorm_k.rmsnorm(_rows(x), wk, eps, newton_iters, n_segments)
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


def flash_padded(q, k, v, block_q: int = 128, block_k: int = 128):
    """The reference wrapper's pad-and-mask: (..., S, hd) q/k/v flattened to
    (BH, S, hd), q zero-padded to a ``min(block_q, Sq)`` multiple and k/v to
    a ``min(block_k, Sk)`` multiple; a tensor that needs no padding and is
    contiguous and 16-byte aligned is passed on as it is (a view, no copy).
    Returns (q3, k3, v3, the kernel's keywords ``block_k`` and ``sk_real``);
    slice ``[:, :Sq]`` off the output."""
    s, hd = q.shape[-2:]
    q3 = q.reshape(-1, s, hd)
    k3 = k.reshape(-1, k.shape[-2], hd)
    v3 = v.reshape(-1, v.shape[-2], hd)
    sk = k3.shape[1]
    bq, bk = min(block_q, s), min(block_k, sk)

    def padded(t, n, to):
        # Whole blocks, contiguous and on a 16-byte boundary (which the bf16
        # kernel wants): the tensor itself, not a copy.
        if n % to == 0 and t.is_contiguous() and t.data_ptr() % 16 == 0:
            return t
        return torch.nn.functional.pad(t, (0, 0, 0, -n % to)).contiguous()

    return (padded(q3, s, bq), padded(k3, sk, bk), padded(v3, sk, bk),
            dict(block_k=bk, sk_real=sk))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k, n_iters, precision_bits, schedule):
        q3, k3, v3, kw = flash_padded(q, k, v, block_q, block_k)
        o = flash_k.flash_attention(q3, k3, v3, causal=causal, n_iters=n_iters,
                                    precision_bits=precision_bits, schedule=schedule, **kw)
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return o[:, :q.shape[-2]].reshape(q.shape)

    @staticmethod
    def backward(ctx, g):
        # The standard attention gradient on the recomputed f32 scores with
        # an exact softmax, as the reference's _flash_bwd (no kernel).
        q, k, v = ctx.saved_tensors
        qf, kf, vf, gf = (t.to(torch.float32) for t in (q, k, v, g))
        scale = torch.tensor(np.float32(1.0 / math.sqrt(q.shape[-1])), device=q.device)
        s = torch.einsum("...qh,...kh->...qk", qf, kf) * scale
        if ctx.causal:
            s = torch.where(flash_k.causal_mask(*s.shape[-2:], q.device), s, flash_k.NEG_INF)
        p = torch.softmax(s, dim=-1)
        dv = torch.einsum("...qk,...qh->...kh", p, gf)
        dp = torch.einsum("...qh,...kh->...qk", gf, vf)
        ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
        dq = torch.einsum("...qk,...kh->...qh", ds, kf) * scale
        dk = torch.einsum("...qk,...qh->...kh", ds, qf) * scale
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = 128, block_k: int = 128,
                    n_iters: int = 2, precision_bits: int = 24,
                    schedule: str = "factored") -> torch.Tensor:
    """Flash attention with the division unit's 1/l over (..., S, hd)
    f32/bf16 q/k/v of any lengths, with the recompute backward."""
    return _FlashAttention.apply(q, k, v, causal, block_q, block_k, n_iters,
                                 precision_bits, schedule)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor as contiguous uint32 lanes (x mod 2^32)."""
    if x.dtype == torch.uint32:
        return x.contiguous()
    return ilm_k.to_u32(as_u32_lanes(x)).contiguous()


def ilm_mul(a: torch.Tensor, b: torch.Tensor, *, iters: int = 16) -> torch.Tensor:
    """ILM products through the kernel, any shape (operands broadcast)."""
    a, b = torch.broadcast_tensors(a, b)
    return ilm_k.ilm_mul(_u32(a), _u32(b), iters)


def ilm_square(a: torch.Tensor, *, iters: int = 16) -> torch.Tensor:
    """ILM squares through the kernel, any shape."""
    return ilm_k.ilm_square(_u32(a), iters)
