"""Hopper kernels of the division unit and their plain PyTorch versions.

Layout per kernel: ``csrc/`` (CUDA C++ for sm_90a, built by ``_build.py``),
``common.py`` (plain versions), ``tsdiv.py`` (launch wrappers and counts),
``ops.py`` (shape-generic entry points with VJPs), ``ref.py`` (oracles).
"""
from . import ops, ref

__all__ = ["ops", "ref"]
