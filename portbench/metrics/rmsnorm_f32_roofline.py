"""The RMSNorm kernel's share of its memory roofline in the profiled
stretch (every block's norms, the Mamba-2 gated norm, the final norm)."""
from portbench.metrics._common import roofline

KERNELS = ("rmsnorm_f32",)


def read(run):
    return roofline(run, "rmsnorm_f32")
