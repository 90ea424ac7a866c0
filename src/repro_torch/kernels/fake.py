"""The kernel wrappers' path for fake tensors (the dry run's trace).

``launch/dryrun.py`` traces the port's programs on the fake tensors of a
``torch._subclasses.fake_tensor.FakeTensorMode``: shapes, dtypes and
devices, no storage. A kernel cannot run on them, and neither should its
plain version, whose arithmetic the trace does not need. So a wrapper whose
operands are fake returns an empty tensor of its output's shape, dtype and
device, and counts the call in :data:`CALLS`, never in its ``LAUNCHES``. A
real tensor never takes this path: on the card it launches the kernel or
raises, on the CPU it runs the plain version.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import is_fake as _is_fake

__all__ = ["CALLS", "reset", "is_fake", "call"]

# kernel -> wrapper calls on fake tensors
CALLS: dict = {}


def reset() -> None:
    CALLS.clear()


def is_fake(*ts: torch.Tensor) -> bool:
    # A plain tensor is not fake: the check costs the real path a type test.
    return any(type(t) is not torch.Tensor and _is_fake(t) for t in ts)


def call(name: str, out: torch.Tensor) -> torch.Tensor:
    """Count a fake call of kernel ``name`` and return ``out``, the output's
    stand-in."""
    CALLS[name] = CALLS.get(name, 0) + 1
    return out
