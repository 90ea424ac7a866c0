"""Oracles of the fused division-unit kernels, per kernel in two tiers.

  * ``*_ref``   — the kernel's plain version (bit-identical to the kernel);
  * ``*_exact`` — the exact op, as torch computes it.
"""
from __future__ import annotations

import torch

from repro_torch.core.seeds import compute_segments, rsqrt_seed_table
from . import common

__all__ = ["tsdiv_recip_ref", "tsdiv_recip_exact", "tsdiv_divide_ref",
           "tsdiv_divide_exact", "tsdiv_rsqrt_ref", "tsdiv_rsqrt_exact"]


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
