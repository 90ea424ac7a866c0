"""LR schedules: pure functions of the step, in f32, passed to
``adamw.update`` as ``lr_scale`` (the port of ``src/repro/optim/schedule.py``)."""
from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant"]


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def warmup_cosine(step, *, warmup_steps: int = 100, total_steps: int = 10_000,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to min_ratio. Returns a scale in (0,1]."""
    step = torch.as_tensor(step, dtype=torch.float32)
    # Tensor divisors: a CUDA tensor over a Python scalar is a multiply by
    # its reciprocal, not the reference's f32 divide.
    warm = torch.clamp(torch.div(step, _f32(max(warmup_steps, 1), step)), max=1.0)
    frac = torch.clamp(torch.div(step - warmup_steps,
                                 _f32(max(total_steps - warmup_steps, 1), step)), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(_f32(math.pi, step) * frac))
    return warm * cos


def constant(step, *, value: float = 1.0) -> torch.Tensor:
    return torch.full_like(torch.as_tensor(step, dtype=torch.float32), value)
