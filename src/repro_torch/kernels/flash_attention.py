"""Flash attention with the division unit's 1/l: launch wrappers, launch counts
and plain versions.

Two kernels replace the reference's Pallas kernel, routed by the dtype of
q/k/v (:func:`kernel_for`): f32 goes to ``csrc/flash_attention.cu``
``flash_attention_f32`` (CUDA cores, plain version
:func:`flash_attention_plain`), bf16 to ``csrc/flash_attention_tc.cu``
``flash_attention_bf16`` (tensor cores, plain version
:func:`flash_attention_tc_plain`, whose order is described there). Both
compute the reference's ``src/repro/kernels/flash_attention.py``
``flash_attention`` / ``_flash_kernel``: causal (or full) online-softmax
attention over ``(BH, S, hd)`` whose running statistics ``m``, ``l`` and
``acc`` update once per key block, with masked scores at ``NEG_INF =
-1e30`` (causal and ``sk_real``), early skip of key blocks above the
diagonal, and the final ``acc * (1/l)`` with ``1/l`` from the division
unit's ``recip_f32_bits``. f32 or bf16 in, f32 inside, q's type out.

The bits depend on the key blocking, not on the query tiling: ``m`` is
updated once per key block, so ``corr = exp(m_prev - m_new)`` and the
rescaled ``l``, ``acc`` round per block. Kernel and plain version therefore
share ``block_k`` and the order of every sum, which is for the f32 kernel,
per query row and key block:

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

The tensor-core kernel is held to its plain version by a gate, not bit for
bit: inside one ``mma`` the tensor core's sum can move a score or an
accumulator by a few f32 ulps from the plain version's model of it, which
moves a bf16 output by at most one rounding. :func:`tc_gate` states it.

On a CPU tensor the wrapper runs the plain version of the kernel that its
dtype routes to; on a CUDA tensor it launches that kernel or raises (head
sizes 16, 32, 64 and 128, ``block_k`` at most 128, f32 or bf16, contiguous;
the bf16 kernel also wants q/k/v on 16-byte boundaries). There is no fallback
from one kernel to the other. Fake tensors take :mod:`.fake`'s path.
``LAUNCHES`` counts launches, as in :mod:`.tsdiv`.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.seeds import SeedTable, compute_segments
from . import _build, common, fake
from .softmax import DTYPES
from .tsdiv import SCHEDULES, _check, _check_schedule, _ptr, _stream, _table_c

__all__ = ["LAUNCHES", "reset_launches", "NEG_INF", "HEAD_DIMS", "MAX_BLOCK_K", "MMA_K",
           "causal_mask", "kernel_for", "flash_attention_plain", "split_bf16",
           "quad_row_sum", "flash_attention_tc_plain", "bf16_ulp", "tc_gate",
           "flash_attention"]

LAUNCHES = {"flash_attention_f32": 0, "flash_attention_bf16": 0}
NEG_INF = -1e30              # masked scores; the twin and models/attention use it
HEAD_DIMS = (16, 32, 64, 128)     # the head sizes csrc/flash_attention.cu instantiates
MAX_BLOCK_K = 128                 # kMaxBlockK there (and in flash_attention_tc.cu)
MMA_K = 16        # the depth of one m16n8k16 mma: keys (and head dims) per k-step
QUAD = 4          # threads of an mma fragment row (csrc/flash_attention_tc.cu)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_for(dtype: torch.dtype) -> str:
    """The kernel that q/k/v of ``dtype`` go to: bf16 to the tensor cores,
    anything else to the f32 kernel (which takes only f32 on the card; a
    CPU tensor of another dtype runs its plain version)."""
    return "flash_attention_bf16" if dtype == torch.bfloat16 else "flash_attention_f32"


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


def _mma_step(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``acc + a @ b`` for one mma k-step (``a`` (..., M, 16), ``b`` (..., 16,
    N)), modelled as the exact products summed with the f32 accumulator and
    rounded once to f32: bf16 x bf16 products are exact, and the tensor
    core's order inside one instruction is not documented."""
    return (acc.double() + a.double() @ b.double()).to(torch.float32)


def split_bf16(p: torch.Tensor):
    """``(p_hi, p_lo)`` as f32: ``p_hi = bf16(p)``, ``p_lo = bf16(p - p_hi)``
    (the difference is exact in f32), both rounded to nearest even."""
    hi = p.to(torch.bfloat16).to(torch.float32)
    return hi, (p - hi).to(torch.bfloat16).to(torch.float32)


def quad_row_sum(p: torch.Tensor) -> torch.Tensor:
    """Sums over the last axis (a multiple of 8 keys) in the tensor-core
    kernel's order: thread t of the quad adds columns 8n + 2t and 8n + 2t + 1
    for n = 0, 1, ... in that order onto +0; then ``(t0 + t1) + (t2 + t3)``.
    Returns the sums with a kept last axis."""
    x = p.reshape(*p.shape[:-1], -1, QUAD, 2)           # (..., n, t, e)
    part = torch.zeros(x.shape[:-3] + (QUAD,), dtype=p.dtype, device=p.device)
    for n in range(x.shape[-3]):
        for e in range(2):
            part = part + x[..., n, :, e]
    return ((part[..., 0] + part[..., 1]) + (part[..., 2] + part[..., 3]))[..., None]


def flash_attention_tc_plain(q, k, v, table: SeedTable, n_iters: int, schedule: str, *,
                             causal: bool, block_k: int, sk_real: int,
                             skip_masked_k: bool) -> torch.Tensor:
    """The tensor-core kernel's arithmetic in torch ops, in its order.

    Per key block (padded with masked zero keys to a multiple of ``MMA_K``):
    ``s`` from +0 by one :func:`_mma_step` per 16 head dims in order, then
    ``s * scale`` and the masks; ``m_new = max(m, max_j s_j)``; ``corr =
    exp(m - m_new)``, ``p = exp(s - m_new)``; ``l = l*corr +``
    :func:`quad_row_sum` ``(p)``; ``acc = acc*corr``, then per 16 keys in
    order one :func:`_mma_step` with ``p_hi`` and one with ``p_lo``
    (:func:`split_bf16`); the early skip as in :func:`flash_attention_plain`.
    Vectorised over keys inside each step.
    """
    bh, sq, hd = q.shape
    sk = k.shape[1]
    dev = q.device
    bkp = -(-block_k // MMA_K) * MMA_K
    qd = q.to(torch.float64)
    scale = torch.tensor(np.float32(1.0 / math.sqrt(hd)), device=dev)
    m = torch.full((bh, sq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((bh, sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((bh, sq, hd), dtype=torch.float32, device=dev)
    qpos = torch.arange(sq, device=dev)[:, None]
    j = torch.arange(bkp, device=dev)
    for k0 in range(0, sk, block_k):
        if causal and skip_masked_k and k0 > sq - 1:
            break                         # no row runs this block or any later one
        pad = (0, 0, 0, bkp - block_k)
        kb = torch.nn.functional.pad(k[:, k0:k0 + block_k], pad).to(torch.float64)
        vb = torch.nn.functional.pad(v[:, k0:k0 + block_k], pad).to(torch.float64)
        s = torch.zeros((bh, sq, bkp), dtype=torch.float32, device=dev)
        for d0 in range(0, hd, MMA_K):
            s = _mma_step(s, qd[..., d0:d0 + MMA_K], kb[..., d0:d0 + MMA_K].transpose(1, 2))
        s = s * scale
        kpos = k0 + j
        dead = (j >= block_k) | (kpos >= sk_real)
        if causal:
            dead = dead | (kpos > qpos)
        s = torch.where(dead, NEG_INF, s)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l_new = l * corr + quad_row_sum(p)
        hi, lo = split_bf16(p)
        acc_new = acc * corr
        for c0 in range(0, bkp, MMA_K):
            vs = vb[:, c0:c0 + MMA_K]
            acc_new = _mma_step(acc_new, hi[..., c0:c0 + MMA_K], vs)
            acc_new = _mma_step(acc_new, lo[..., c0:c0 + MMA_K], vs)
        if causal and skip_masked_k:
            run = qpos >= k0              # the block has a key at or before the row
            m_new = torch.where(run, m_new, m)
            l_new = torch.where(run, l_new, l)
            acc_new = torch.where(run, acc_new, acc)
        m, l, acc = m_new, l_new, acc_new
    return (acc * common.recip_f32_bits(l, table, n_iters, schedule)).to(q.dtype)


PLAIN = {"flash_attention_f32": flash_attention_plain,
         "flash_attention_bf16": flash_attention_tc_plain}
TC_FLOOR = 2.0 ** -16     # the gate's absolute floor, in units of max|v|
TC_IDENTICAL = 0.99       # the least share of bit-identical lanes


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each value of ``x`` (8 significant bits: 2^(e-7) on
    [2^e, 2^(e+1))), 0 at 0."""
    xf = x.float().abs()
    _, e = torch.frexp(xf)                        # xf = f * 2^e, f in [0.5, 1)
    return torch.where(xf > 0, torch.ldexp(torch.ones_like(xf), e - 8), 0.0)


def tc_gate(got: torch.Tensor, plain: torch.Tensor, max_abs_v: float) -> dict:
    """The bf16 kernel against its plain version, on every lane:
    ``|got - plain| <= ulp_bf16(plain) + TC_FLOOR * max|v|`` (one bf16
    rounding of the output, and an absolute floor for outputs that cancel
    towards 0), and at least ``TC_IDENTICAL`` of the lanes bit-identical.
    Returns the identical share, the worst excess over the bound (<= 0
    passes), the lanes over it, the lanes over the tighter ``2^-8 * |plain|
    + floor`` (half an ulp at the bottom of a binade; reported) and ``ok``."""
    same = (got.view(torch.int16) == plain.view(torch.int16)) | (got.isnan() & plain.isnan())
    d = (got.float() - plain.float()).abs().nan_to_num(nan=math.inf)
    d = torch.where(same, 0.0, d)
    floor = TC_FLOOR * max_abs_v
    excess = d - (bf16_ulp(plain) + floor)
    over_tight = int((d > 2.0 ** -8 * plain.float().abs() + floor).sum())
    share = float(same.double().mean()) if same.numel() else 1.0
    worst = float(excess.max()) if excess.numel() else 0.0
    return {"identical_share": share, "worst_excess": worst,
            "lanes_over": int((excess > 0).sum()), "lanes_over_2^-8": over_tight,
            "ok": worst <= 0 and share >= TC_IDENTICAL}


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
        raise TypeError(f"the flash-attention kernels take contiguous float32 or "
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
    name = kernel_for(q.dtype)
    on_card = _on_card(q, k, v)
    if fake.is_fake(q, k, v):
        return fake.call(name, torch.empty_like(q))
    if not on_card:
        return PLAIN[name](q, k, v, table, n_iters, schedule, **kw)
    _check_schedule(schedule, n_iters)
    bh, sq, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash-attention kernels take head sizes {HEAD_DIMS}, got {hd}")
    if block_k > MAX_BLOCK_K:
        raise ValueError(f"block_k={block_k} above the kernels' {MAX_BLOCK_K}")
    if name == "flash_attention_bf16" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the bf16 flash-attention kernel takes q/k/v on 16-byte boundaries")
    out = torch.empty_like(q)
    if q.numel():
        lib = "flash_attention_tc" if name == "flash_attention_bf16" else "flash_attention"
        with torch.cuda.device(q.device):
            rc = getattr(_build.library(lib), name)(
                _ptr(q), _ptr(k), _ptr(v), _ptr(out), bh, sq, sk, sk_real, hd, block_k,
                int(causal), int(skip_masked_k), float(np.float32(1.0 / math.sqrt(hd))),
                _table_c(table), n_iters, SCHEDULES[schedule], _stream(q))
        _check(rc, name)
        LAUNCHES[name] += 1
    return out
