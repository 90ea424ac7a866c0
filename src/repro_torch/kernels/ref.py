"""Oracles of the fused division-unit kernels, per kernel in two tiers.

  * ``*_ref``   — the kernel's plain version (bit-identical to the kernel;
                  unlike the reference's ``rmsnorm_ref``, which divides by
                  d, it multiplies by the kernel's f32 ``1/d``);
  * ``*_exact`` — the exact op, as torch computes it (the ILM's on uint32
                  lanes: the product mod 2^32, as the reference's).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import ilm as ilm_core
from repro_torch.core.seeds import compute_segments, rsqrt_seed_table
from . import common
from .flash_attention import NEG_INF, PLAIN, causal_mask, kernel_for
from .ilm import ilm_mul_plain, ilm_square_plain, to_u32
from .ops import flash_padded
from .rmsnorm import rmsnorm_plain
from .softmax import softmax_plain

__all__ = ["tsdiv_recip_ref", "tsdiv_recip_exact", "tsdiv_divide_ref",
           "tsdiv_divide_exact", "tsdiv_rsqrt_ref", "tsdiv_rsqrt_exact",
           "rmsnorm_ref", "rmsnorm_exact", "softmax_ref", "softmax_exact",
           "flash_attention_ref", "flash_attention_exact", "ilm_mul_ref",
           "ilm_mul_exact", "ilm_square_ref", "ilm_square_exact"]


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


def flash_attention_ref(q, k, v, *, causal: bool = True, block_q: int = 128,
                        block_k: int = 128, n_iters: int = 2,
                        precision_bits: int = 24, schedule: str = "factored"):
    """The plain version of the kernel that q's dtype routes to (bf16: the
    tensor-core kernel's; else the f32 kernel's) behind
    ``ops.flash_attention``, with its pad-and-mask, on the tensors' own
    device."""
    q3, k3, v3, kw = flash_padded(q, k, v, block_q, block_k)
    o = PLAIN[kernel_for(q.dtype)](q3, k3, v3, compute_segments(n_iters, precision_bits),
                                   n_iters, schedule, causal=causal, skip_masked_k=True, **kw)
    return o[:, :q.shape[-2]].reshape(q.shape)


def flash_attention_exact(q, k, v, *, causal: bool = True):
    """Plain softmax attention oracle. q/k/v: (BH, S, hd)."""
    hd = q.shape[-1]
    s = torch.einsum("bqh,bkh->bqk", q.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(hd)
    if causal:
        s = torch.where(causal_mask(*s.shape[-2:], q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkh->bqh", p, v.to(torch.float32)).to(q.dtype)


def ilm_mul_ref(a, b, *, iters: int = 16):
    return ilm_mul_plain(a, b, iters)


def ilm_mul_exact(a, b):
    return to_u32(ilm_core.as_u32_lanes(a) * ilm_core.as_u32_lanes(b))


def ilm_square_ref(a, *, iters: int = 16):
    return ilm_square_plain(a, iters)


def ilm_square_exact(a):
    a = ilm_core.as_u32_lanes(a)
    return to_u32(a * a)
