"""Hopper kernels of the division unit and their plain PyTorch versions.

Layout: ``csrc/`` (CUDA C++ for sm_90a, one library per ``.cu``, built by
``_build.py``); ``common.py`` (the shared plain bodies and the row-sum
order); ``tsdiv.py``, ``softmax.py``, ``rmsnorm.py``, ``flash_attention.py``,
``ilm.py`` (launch wrappers, launch counts, and the plain versions of the
consumer, attention and ILM kernels); ``fake.py`` (the wrappers' path for
the dry run's fake tensors); ``ops.py`` (shape-generic entry points with
VJPs); ``ref.py`` (oracles).
"""
from . import ops, ref

__all__ = ["ops", "ref"]
