"""The RMSNorm kernel (``csrc/rmsnorm.cu`` ``rmsnorm_rows``): which call
launches it, how its device kernel is named, and the bytes a call needs:
the rows read once, the weight read once, the output written once."""

MODULE = "repro_torch.kernels.rmsnorm"
FUNCTION = "rmsnorm"
DEVICE_NAME = "rmsnorm_kernel"


def call_bytes(args) -> int:
    """Bytes of one call on (M, D) rows ``args[0]`` with weight ``args[1]``."""
    x, w = args[0], args[1]
    return 2 * x.numel() * x.element_size() + w.numel() * w.element_size()
