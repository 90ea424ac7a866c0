"""Oracles of the fused division-unit kernels, per kernel in two tiers.

  * ``*_ref``   — the kernel's plain version (bit-identical to the kernel;
                  unlike the reference's ``rmsnorm_ref``, which divides by
                  d, it multiplies by the kernel's f32 ``1/d``);
  * ``*_exact`` — the exact op, as torch computes it.
"""
from __future__ import annotations

import torch

from repro_torch.core.seeds import compute_segments, rsqrt_seed_table
from . import common
from .rmsnorm import rmsnorm_plain
from .softmax import softmax_plain

__all__ = ["tsdiv_recip_ref", "tsdiv_recip_exact", "tsdiv_divide_ref",
           "tsdiv_divide_exact", "tsdiv_rsqrt_ref", "tsdiv_rsqrt_exact",
           "rmsnorm_ref", "rmsnorm_exact", "softmax_ref", "softmax_exact"]


def tsdiv_recip_ref(x, *, n_iters: int = 2, precision_bits: int = 24,
                    schedule: str = "factored"):
    table = compute_segments(n_iters, precision_bits)
    return common.recip_f32_bits(x.to(torch.float32), table, n_iters, schedule)


def tsdiv_recip_exact(x):
    return 1.0 / x.to(torch.float32)


def tsdiv_divide_ref(a, b, *, n_iters: int = 2, precision_bits: int = 24,
                     schedule: str = "factored"):
    table = compute_segments(n_iters, precision_bits)
    return common.divide_f32_bits(a.to(torch.float32), b.to(torch.float32),
                                  table, n_iters, schedule)


def tsdiv_divide_exact(a, b):
    return a.to(torch.float32) / b.to(torch.float32)


def tsdiv_rsqrt_ref(x, *, newton_iters: int = 2, n_segments: int = 16):
    return common.rsqrt_f32_bits(x.to(torch.float32),
                                 rsqrt_seed_table(n_segments), newton_iters)


def tsdiv_rsqrt_exact(x):
    return torch.rsqrt(x.to(torch.float32))


def _rows(x):
    return x.reshape(-1, x.shape[-1])


def rmsnorm_ref(x, w, *, eps: float = 1e-6, newton_iters: int = 2,
                n_segments: int = 16):
    return rmsnorm_plain(_rows(x), w, eps, rsqrt_seed_table(n_segments),
                         newton_iters).reshape(x.shape)


def rmsnorm_exact(x, w, *, eps: float = 1e-6):
    xf = x.to(torch.float32)
    ss = torch.mean(xf * xf, dim=-1, keepdim=True)
    r = torch.rsqrt(ss + torch.tensor(eps, dtype=torch.float32))
    return (xf * r * w.to(torch.float32)).to(x.dtype)


def softmax_ref(x, *, n_iters: int = 2, precision_bits: int = 24,
                schedule: str = "factored"):
    return softmax_plain(_rows(x), compute_segments(n_iters, precision_bits),
                         n_iters, schedule).reshape(x.shape)


def softmax_exact(x):
    return torch.softmax(x.to(torch.float32), dim=-1).to(x.dtype)
