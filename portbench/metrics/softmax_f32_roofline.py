"""The row-softmax kernel's share of its memory roofline in the profiled
stretch (attention's scores and the MoE router's logits)."""
from portbench.metrics._common import roofline

KERNELS = ("softmax_f32",)


def read(run):
    return roofline(run, "softmax_f32")
