"""Hand the reference's configs and inputs to the port.

This system has no weights: its parameters are the ``DivisionConfig`` and
the seed tables, which are recomputed from ``(n_iters, precision_bits)``.
So a test carries a run across by its config (``dataclasses.asdict`` of the
reference's) and by its numpy inputs (K-Means points and inits, QR
matrices).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.division_modes import DivisionConfig

__all__ = ["config_from_reference", "tensors_from_numpy"]


def config_from_reference(fields: Dict) -> DivisionConfig:
    """The port's config from the reference's ``dataclasses.asdict(cfg)``."""
    return DivisionConfig(**fields)


def tensors_from_numpy(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Same-named tensors on ``device``, bits unchanged."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}
