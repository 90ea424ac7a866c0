// Hopper kernel of the fused RMSNorm, with a plain C interface for ctypes
// (built by kernels/_build.py with nvcc -fmad=false for sm_90a).
//
// Replaces the reference's Pallas TPU kernel src/repro/kernels/rmsnorm.py
// rmsnorm_2d / _rmsnorm_kernel: ss = sum(x*x) * (1/d_real), se = ss + eps,
// r = rsqrt_f32(se) (PWL seed + compensated Newton), r = 0 where se is inf and
// nan where se is nan, out = (x * r) * w rounded to x's type.
//
// Rounding sites: the compiled reference fuses ss*(1/d) + eps into one fma
// and does not fuse x*x into the sum (measured against it in interpret
// mode, tests/test_torch_consumers.py); the Newton sites are rsqrt_f32_bits'.
//
// Bound: memory. It reads x and writes the output once (4 bytes per bf16
// element, 8 per f32) plus w, against ~6 f32 operations per element.
//
// Design: one block of rows::kThreads threads per row, a loop over the row
// inside the block, the sum of squares in rows.cuh's fixed order (repeated
// by the plain version in kernels/rmsnorm.py), and a second pass that
// scales. Rows of any length are taken whole, so no padding is needed and
// the divisor is the row's own length.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "rows.cuh"
#include "tsdiv_body.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(rows::kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out,
                   int d, float inv_d, float eps, const __grid_constant__ TsdivSeedTable table, int newton_iters) {
  __shared__ float sh[rows::kThreads];
  const long long base = (long long)blockIdx.x * d;
  const T* xr = x + base;
  T* orow = out + base;
  float acc = 0.0f;
  for (int j = threadIdx.x; j < d; j += rows::kThreads) {
    const float v = rows::to_f(xr[j]);
    acc = __fadd_rn(acc, __fmul_rn(v, v));
  }
  const float ss = rows::tree_sum(acc, sh);
  const float se = __fmaf_rn(ss, inv_d, eps);
  float r = tsdiv::rsqrt_f32(se, table, newton_iters);
  if (isinf(se)) r = 0.0f;
  if (isnan(se)) r = __uint_as_float(tsdiv::kNanBits);
  for (int j = threadIdx.x; j < d; j += rows::kThreads)
    rows::store(orow + j, __fmul_rn(__fmul_rn(rows::to_f(xr[j]), r), w[j]));
}

template <typename T>
int launch(const void* x, const float* w, void* out, long long m, int d, float inv_d, float eps,
           TsdivSeedTable table, int newton_iters, cudaStream_t stream) {
  rmsnorm_kernel<T><<<(unsigned int)m, rows::kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(out), d, inv_d, eps, table, newton_iters);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: contiguous (m, d) rows; w: (d,) f32; dtype 0 = f32, 1 = bf16.
// Returns the launch's cudaGetLastError().
int rmsnorm_rows(const void* x, const float* w, void* out, long long m, int d, int dtype,
                 float inv_d, float eps, TsdivSeedTable table, int newton_iters,
                 cudaStream_t stream) {
  return dtype == 0
             ? launch<float>(x, w, out, m, d, inv_d, eps, table, newton_iters, stream)
             : launch<__nv_bfloat16>(x, w, out, m, d, inv_d, eps, table, newton_iters, stream);
}

}  // extern "C"
