"""Core: the paper's Taylor-series division unit as PyTorch modules."""
from . import powering, seeds, taylor
from .division_modes import (EXACT, MODES, TAYLOR, DivisionConfig, div, recip,
                             rsqrt)
from .seeds import SeedTable, compute_segments

__all__ = [
    "powering", "seeds", "taylor",
    "DivisionConfig", "MODES", "EXACT", "TAYLOR",
    "div", "recip", "rsqrt",
    "SeedTable", "compute_segments",
]
