"""The division-consumer workloads the paper names: K-Means and Givens QR.

Every divide and rsqrt goes through ``repro_torch.core.division_modes``, so
one ``DivisionConfig`` swaps the whole workload between torch's divider and
the paper's unit.
"""
from . import kmeans, qr  # noqa: F401

__all__ = ["kmeans", "qr"]
