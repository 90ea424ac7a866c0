"""Division-accuracy measurement for the port.

  * ``ulp``              — exact ULP distance vs the f64 oracle + sweeps
  * ``golden``           — the reference's committed golden stores, checked
    against the port on a chosen device
  * ``workload_metrics`` — K-Means inertia delta, QR residuals
  * ``consumers``        — softmax / RMSNorm row corpora, oracles and gates
"""
from . import consumers, ulp, workload_metrics  # noqa: F401
