"""The row-softmax kernel (``csrc/softmax.cu`` ``softmax_rows``): which
call launches it, how its device kernel is named, and the bytes a call
needs: each input element read once, each output element written once."""

MODULE = "repro_torch.kernels.softmax"
FUNCTION = "softmax"
DEVICE_NAME = "softmax_kernel"


def call_bytes(args) -> int:
    """Bytes of one call on (M, D) rows ``args[0]``."""
    x = args[0]
    return 2 * x.numel() * x.element_size()
