"""ILM multiplier and squarer kernels: launch wrappers, launch counts and
plain versions.

The kernels (``csrc/ilm.cu`` ``ilm_mul_u32`` and ``ilm_square_u32``) replace
the reference's Pallas kernels ``src/repro/kernels/ilm.py`` ``ilm_mul_2d``
and ``ilm_square_2d``: ``iters`` stages of the Iterative Logarithmic
Multiplier (priority encoder, leading-one residues, partial product) on
uint32 lanes, exact for operands below 2^16 at 16 stages. Neither runs
the stages: the multiplier computes their closed form ``x*y - rx*ry`` and
the squarer ``x*x - r*r`` (mod 2^32; ``rx``, ``ry``, ``r`` are the operands
with their top ``iters`` set bits cleared), which is the stages' result for
every uint32 operand. The plain versions run the stages. They take contiguous
``torch.uint32`` tensors of one shape and return a new ``torch.uint32``
tensor (one flat launch over the lanes, any rank).

On a CPU tensor the wrapper runs the plain version (:func:`ilm_mul_plain`,
:func:`ilm_square_plain`: the torch twin of ``core/ilm.py`` on int64 lanes,
which touches the uint32 storage only through an int32 view); on a CUDA
tensor it launches the kernel or raises; fake tensors take :mod:`.fake`'s
path. ``LAUNCHES`` counts launches, as in :mod:`.tsdiv`.
"""
from __future__ import annotations

import torch

from repro_torch.core import ilm as ilm_core
from . import _build, fake
from .tsdiv import _check, _ptr, _stream

__all__ = ["LAUNCHES", "reset_launches", "to_u32", "ilm_mul_plain",
           "ilm_square_plain", "ilm_mul", "ilm_square"]

LAUNCHES = {"ilm_mul_u32": 0, "ilm_square_u32": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def to_u32(v: torch.Tensor) -> torch.Tensor:
    """int64 lanes holding uint32 values -> a ``torch.uint32`` tensor."""
    v = v & ilm_core.U32
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32).view(torch.uint32)


def ilm_mul_plain(a: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    return to_u32(ilm_core.ilm_mul(a, b, iters))


def ilm_square_plain(a: torch.Tensor, iters: int) -> torch.Tensor:
    return to_u32(ilm_core.ilm_square(a, iters))


def _on_card(*ts: torch.Tensor) -> bool:
    """False for CPU tensors (plain version); True for CUDA tensors that the
    kernel takes; raises for anything else."""
    dev = ts[0].device
    for t in ts:
        if t.device != dev or t.shape != ts[0].shape:
            raise ValueError("operands must share one device and one shape")
        if t.dtype != torch.uint32 or not t.is_contiguous():
            raise TypeError(f"ILM kernels take contiguous uint32, got {t.dtype}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise RuntimeError(f"no ILM kernel for device {dev}")
    return True


def ilm_mul(a: torch.Tensor, b: torch.Tensor, iters: int = 16) -> torch.Tensor:
    """ILM products of uint32 lanes (operands < 2^16), ``iters`` stages."""
    on_card = _on_card(a, b)
    if fake.is_fake(a, b):
        return fake.call("ilm_mul_u32", torch.empty_like(a))
    if not on_card:
        return ilm_mul_plain(a, b, iters)
    out = torch.empty_like(a)
    if a.numel():
        with torch.cuda.device(a.device):
            rc = _build.library("ilm").ilm_mul_u32(
                _ptr(a), _ptr(b), _ptr(out), a.numel(), iters, _stream(a))
        _check(rc, "ilm_mul_u32")
        LAUNCHES["ilm_mul_u32"] += 1
    return out


def ilm_square(a: torch.Tensor, iters: int = 16) -> torch.Tensor:
    """ILM squares of uint32 lanes, ``iters`` stages (exact below 2^16 at 16)."""
    on_card = _on_card(a)
    if fake.is_fake(a):
        return fake.call("ilm_square_u32", torch.empty_like(a))
    if not on_card:
        return ilm_square_plain(a, iters)
    out = torch.empty_like(a)
    if a.numel():
        with torch.cuda.device(a.device):
            rc = _build.library("ilm").ilm_square_u32(
                _ptr(a), _ptr(out), a.numel(), iters, _stream(a))
        _check(rc, "ilm_square_u32")
        LAUNCHES["ilm_square_u32"] += 1
    return out
