"""PyTorch/CUDA port of the Taylor-series division unit (arXiv:1705.00218).

Beside the JAX reference in ``repro``: the division unit's recip / div /
rsqrt and its consumers softmax / RMSNorm, with hand-written CUDA kernels
for Hopper (``kernels/``); the K-Means and Givens-QR workloads on it; the
LMs of every architecture (``configs/``, ``models/``) served on it
(``serving/``, ``launch/serve.py``) and trained on it (``optim/``,
``train/``, ``data/``, ``launch/train.py``), and data parallel over a
device mesh of ranks (``sharding/``, ``launch/mesh.py``). Imports torch and
numpy only.
"""
from .core.division_modes import (EXACT, MODES, TAYLOR, DivisionConfig, div,
                                  recip, rsqrt)
from .workloads.kmeans import kmeans, make_blobs
from .workloads.qr import qr_givens, qr_givens_batched

__all__ = ["DivisionConfig", "MODES", "EXACT", "TAYLOR", "recip", "div",
           "rsqrt", "kmeans", "make_blobs", "qr_givens", "qr_givens_batched"]
