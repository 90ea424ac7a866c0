"""Flash attention with the division unit's 1/l: launch wrapper, launch count
and plain version.

The kernel (``csrc/flash_attention.cu`` ``flash_attention_f32``) replaces the
reference's Pallas kernel ``src/repro/kernels/flash_attention.py``
``flash_attention`` / ``_flash_kernel``: causal (or full) online-softmax
attention over ``(BH, S, hd)`` whose running statistics ``m``, ``l`` and
``acc`` update once per key block, with masked scores at ``NEG_INF =
-1e30`` (causal and ``sk_real``), early skip of key blocks above the
diagonal, and the final ``acc * (1/l)`` with ``1/l`` from the division
unit's ``recip_f32_bits``. f32 or bf16 in, f32 inside, q's type out.

The bits depend on the key blocking, not on the query tiling: ``m`` is
updated once per key block, so ``corr = exp(m_prev - m_new)`` and the
rescaled ``l``, ``acc`` round per block. Kernel and plain version therefore
share ``block_k`` and the order of every sum, which is, per query row and
key block:

  * the score: ``s = fma(q[d], k[d], s)`` over d = 0 .. hd-1 from +0, then
    ``s * scale``, then the masks;
  * ``m_new = max(m, max_j s_j)`` (nan propagates);
  * ``l = l * corr`` and ``acc = acc * corr``; then, for each key j of the
    block in order, ``l = l + p_j`` and ``acc = fma(p_j, v_j, acc)`` with
    ``p_j = exp(s_j - m_new)``.

The reference sums ``p`` and ``p @ v`` over the block first and adds
``corr * l`` after; the port's order is a different rounding of the same
sums (tests hold the two to the reference's tolerances). A row skips a key
block that lies wholly above its diagonal (``causal`` and ``skip_masked_k``):
its state is unchanged, as it would be bit for bit had the block run (every
``p`` is exactly 0 and ``corr`` exactly 1), so the skip is part of both
versions and ``skip_masked_k=False`` gives the same bits.

On a CPU tensor the wrapper runs :func:`flash_attention_plain`; on a CUDA
tensor it launches the kernel or raises (head sizes 16, 32, 64 and 128,
``block_k`` at most 128). ``LAUNCHES`` counts launches, as in :mod:`.tsdiv`.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.seeds import SeedTable, compute_segments
from . import _build, common
from .softmax import DTYPES
from .tsdiv import SCHEDULES, _check, _check_schedule, _ptr, _stream, _table_c

__all__ = ["LAUNCHES", "reset_launches", "NEG_INF", "HEAD_DIMS", "MAX_BLOCK_K",
           "causal_mask", "flash_attention_plain", "flash_attention"]

LAUNCHES = {"flash_attention_f32": 0}
NEG_INF = -1e30              # masked scores; the twin and models/attention use it
HEAD_DIMS = (16, 32, 64, 128)     # the head sizes csrc/flash_attention.cu instantiates
MAX_BLOCK_K = 128                 # kMaxBlockK there


def reset_launches() -> None:
    LAUNCHES["flash_attention_f32"] = 0


def causal_mask(sq: int, sk: int, device=None) -> torch.Tensor:
    """(sq, sk) bools: query i attends to keys j <= i."""
    return (torch.arange(sq, device=device)[:, None]
            >= torch.arange(sk, device=device)[None, :])


def flash_attention_plain(q, k, v, table: SeedTable, n_iters: int, schedule: str, *,
                          causal: bool, block_k: int, sk_real: int,
                          skip_masked_k: bool) -> torch.Tensor:
    """The kernel's arithmetic in torch ops, in its order (module docstring).

    A Python loop over the head dimension and over the keys of each block:
    meant for checks, not for speed.
    """
    bh, sq, hd = q.shape
    sk = k.shape[1]
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    scale = torch.tensor(np.float32(1.0 / math.sqrt(hd)), device=q.device)
    m = torch.full((bh, sq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((bh, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((bh, sq, hd), dtype=torch.float32, device=q.device)
    qpos = torch.arange(sq, device=q.device)[:, None]
    for k0 in range(0, sk, block_k):
        kb, vb = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
        s = torch.zeros((bh, sq, kb.shape[1]), dtype=torch.float32, device=q.device)
        for d in range(hd):
            s = common.fma(qf[:, :, d:d + 1], kb[:, None, :, d], s)
        s = s * scale
        kpos = k0 + torch.arange(kb.shape[1], device=q.device)
        if causal:
            s = torch.where(qpos >= kpos, s, NEG_INF)
        s = torch.where(kpos < sk_real, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l_new, acc_new = l * corr, acc * corr
        for j in range(kb.shape[1]):
            l_new = l_new + p[..., j:j + 1]
            acc_new = common.fma(p[..., j:j + 1], vb[:, None, j, :], acc_new)
        if causal and skip_masked_k:
            run = qpos >= k0              # the block has a key at or before the row
            m_new = torch.where(run, m_new, m)
            l_new = torch.where(run, l_new, l)
            acc_new = torch.where(run, acc_new, acc)
        m, l, acc = m_new, l_new, acc_new
    return (acc * common.recip_f32_bits(l, table, n_iters, schedule)).to(q.dtype)


def _on_card(q, k, v) -> bool:
    """False for CPU tensors (plain version); True for CUDA tensors that the
    kernel takes; raises for anything else."""
    for t in (q, k, v):
        if t.device != q.device or t.dtype != q.dtype or t.dim() != 3:
            raise ValueError("q, k, v must be 3-D tensors of one device and dtype")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise RuntimeError(f"no flash-attention kernel for device {q.device}")
    if q.dtype not in DTYPES or not all(t.is_contiguous() for t in (q, k, v)):
        raise TypeError(f"the flash-attention kernel takes contiguous float32 or "
                        f"bfloat16, got {q.dtype}")
    return True


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_k: int = 128, n_iters: int = 2,
                    precision_bits: int = 24, schedule: str = "factored",
                    sk_real: int | None = None,
                    skip_masked_k: bool = True) -> torch.Tensor:
    """q (BH, Sq, hd), k/v (BH, Sk, hd) -> (BH, Sq, hd) in q's dtype.

    Sk must be a multiple of ``min(block_k, Sk)`` (``ops.flash_attention``
    pads); keys at or past ``sk_real`` are masked out.
    """
    sk = k.shape[1]
    block_k = min(block_k, sk)
    if sk == 0 or sk % block_k:
        raise ValueError(f"key length {sk} is not a positive multiple of block_k={block_k}")
    sk_real = sk if sk_real is None else sk_real
    table = compute_segments(n_iters, precision_bits)
    kw = dict(causal=causal, block_k=block_k, sk_real=sk_real, skip_masked_k=skip_masked_k)
    if not _on_card(q, k, v):
        return flash_attention_plain(q, k, v, table, n_iters, schedule, **kw)
    _check_schedule(schedule, n_iters)
    bh, sq, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash-attention kernel takes head sizes {HEAD_DIMS}, got {hd}")
    if block_k > MAX_BLOCK_K:
        raise ValueError(f"block_k={block_k} above the kernel's {MAX_BLOCK_K}")
    out = torch.empty_like(q)
    if q.numel():
        with torch.cuda.device(q.device):
            rc = _build.library("flash_attention").flash_attention_f32(
                _ptr(q), _ptr(k), _ptr(v), _ptr(out), bh, sq, sk, sk_real, hd, block_k,
                int(causal), int(skip_masked_k), float(np.float32(1.0 / math.sqrt(hd))),
                DTYPES[q.dtype], _table_c(table), n_iters, SCHEDULES[schedule], _stream(q))
        _check(rc, "flash_attention_f32")
        LAUNCHES["flash_attention_f32"] += 1
    return out
