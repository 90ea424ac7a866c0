"""Division dispatch: the paper's unit as one config knob.

The PyTorch counterpart of ``src/repro/core/division_modes.py`` for the
scalar ops :func:`recip`, :func:`div` and :func:`rsqrt` and their consumers
:func:`softmax` and :func:`rmsnorm`. Modes:

  * ``exact``              — torch's own divide / rsqrt (the baseline).
  * ``taylor``             — the paper's unit as torch ops (PWL seed + series).
  * ``taylor_pallas``      — the fused kernel: the hand-written CUDA kernel
                             for a CUDA tensor, its plain version for a CPU
                             tensor (the name is kept so configs round-trip).
  * ``goldschmidt``        — Goldschmidt N/D refinement on the same seed ROM.
  * ``goldschmidt_pallas`` — the same refinement in the fused kernel.
  * ``ilm``                — not ported yet (ROADMAP Queue 1 item 7).

The consumers :func:`softmax` and :func:`rmsnorm` route every mode the same
way, the kernel modes to the fused softmax and RMSNorm kernels. A CUDA
tensor in a ``*_pallas`` mode launches the kernel or raises; nothing falls
back to another path or to the CPU. ``attention`` is not ported yet and
raises.
"""
from __future__ import annotations

import dataclasses

import torch

from . import goldschmidt, taylor
from .fpparts import UNDERFLOW_POLICIES
from .seeds import compute_segments, rsqrt_seed_table

__all__ = ["MODES", "DivisionConfig", "EXACT", "TAYLOR", "effective_underflow",
           "recip", "div", "rsqrt", "softmax", "rmsnorm", "attention"]

MODES = ("exact", "taylor", "taylor_pallas", "goldschmidt",
         "goldschmidt_pallas", "ilm")
_KERNEL_MODES = ("taylor_pallas", "goldschmidt_pallas")
_ILM_TODO = "mode='ilm' is not ported yet (ROADMAP Queue 1 item 7)"


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
        raise NotImplementedError(_ILM_TODO)
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
    """
    if not torch.is_tensor(a):
        a = _as_tensor(a, b)
    b = _as_tensor(b, a)
    if cfg.mode == "exact":
        return a / b
    if cfg.mode == "ilm":
        raise NotImplementedError(_ILM_TODO)
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
        raise NotImplementedError(_ILM_TODO)
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
    if cfg.mode == "ilm":
        raise NotImplementedError(_ILM_TODO)
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
    if cfg.mode == "ilm":
        raise NotImplementedError(_ILM_TODO)
    if cfg.mode in _KERNEL_MODES and _takes_kernel(x):
        from repro_torch.kernels import ops as kops

        return kops.rmsnorm(x, w, eps, cfg.rsqrt_newton, cfg.rsqrt_segments)
    from repro_torch.kernels.common import row_sum

    xf = x.to(torch.float32)
    se = row_sum(xf * xf) / x.shape[-1] + torch.tensor(eps, dtype=torch.float32)
    r = torch.rsqrt(se) if cfg.mode == "exact" else rsqrt(se, cfg)
    return (xf * r * w.to(torch.float32)).to(x.dtype)


def attention(*args, **kwargs):
    """Not ported yet: flash attention is the next slice (ROADMAP Queue 1
    item 9, Queue 2 item 7)."""
    raise NotImplementedError("attention and the flash-attention kernel are "
                              "the next slice of the port (ROADMAP Queue 1 "
                              "item 9)")
