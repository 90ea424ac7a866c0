"""Kernel families by device-kernel name, the first that matches: cuBLAS's
GEMMs and GEMVs, the port's kernels, casts and copies, reductions, the
rest of torch's elementwise kernels. A copy of the table that the repo's
serving profiler uses, so that the breakdown's families stay fixed."""

FAMILIES = (("gemm", ("gemm", "gemv", "xmma", "cutlass", "nvjet")),
            ("division unit", ("softmax_kernel", "rmsnorm_kernel", "tsdiv", "recip_")),
            ("cast or copy", ("direct_copy", "memcpy", "memset", "cat", "index")),
            ("reduction", ("reduce", "scan", "sort", "topk")),
            ("elementwise", ("elementwise",)))


def family(name: str) -> str:
    low = name.lower()
    return next((f for f, keys in FAMILIES if any(k in low for k in keys)), "other")
