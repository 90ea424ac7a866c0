"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, no sparsity), at its full 700 W power limit."""

BF16_FLOPS = 989e12      # tensor cores, bf16 and fp16
TF32_FLOPS = 495e12
F32_FLOPS = 67e12        # outside the tensor cores
HBM_BYTES = 3.35e12      # bytes a second
HBM_CAPACITY = 80e9
