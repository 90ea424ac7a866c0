// Hopper kernel of the fused row softmax, with a plain C interface for ctypes
// (built by kernels/_build.py with nvcc -fmad=false for sm_90a).
//
// Replaces the reference's Pallas TPU kernel src/repro/kernels/softmax.py
// softmax_2d / _softmax_kernel: row max, exp(x - max), row sum, and the sum's
// reciprocal through the division unit (recip_f32_bits), then ex * (1/sum).
// Rows whose max is not finite shift by 0; a row whose sum is 0 (every logit
// -inf) comes out as zeros.
//
// Bound: memory. It reads each element and writes each output once (8 bytes
// per f32 element, 4 per bf16), against ~20 f32 operations per element
// (exp included), far below the card's f32 rate per byte.
//
// Design: one block of rows::kThreads threads per row and a loop over the
// row inside the block, in place of the TPU's whole-row VMEM block. The row
// is read three times (max, sum, scale) and exp is computed twice; the
// second and third reads mostly hit L1/L2. The sum runs in rows.cuh's fixed
// order, which the plain version (kernels/softmax.py) repeats bit for bit.
// Rows of any length are taken whole: no padding, no lane masks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "rows.cuh"
#include "tsdiv_body.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(rows::kThreads)
    softmax_kernel(const T* __restrict__ x, T* __restrict__ out, int d,
                   const __grid_constant__ TsdivSeedTable table, int n_iters, int schedule) {
  __shared__ float sh[rows::kThreads];
  const long long base = (long long)blockIdx.x * d;
  const T* xr = x + base;
  T* orow = out + base;
  float m = -INFINITY;
  for (int j = threadIdx.x; j < d; j += rows::kThreads) m = rows::nan_max(m, rows::to_f(xr[j]));
  m = rows::tree_max(m, sh);
  const float mfin = isfinite(m) ? m : 0.0f;
  float acc = 0.0f;
  for (int j = threadIdx.x; j < d; j += rows::kThreads)
    acc = __fadd_rn(acc, expf(__fsub_rn(rows::to_f(xr[j]), mfin)));
  const float s = rows::tree_sum(acc, sh);
  const float rs = tsdiv::recip_f32_bits(s, table, n_iters, schedule);
  for (int j = threadIdx.x; j < d; j += rows::kThreads) {
    const float ex = expf(__fsub_rn(rows::to_f(xr[j]), mfin));
    rows::store(orow + j, s == 0.0f ? 0.0f : __fmul_rn(ex, rs));
  }
}

template <typename T>
int launch(const void* x, void* out, long long m, int d, TsdivSeedTable table, int n_iters,
           int schedule, cudaStream_t stream) {
  softmax_kernel<T><<<(unsigned int)m, rows::kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), d, table, n_iters, schedule);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: contiguous (m, d) rows; dtype 0 = f32, 1 = bf16. Returns the
// launch's cudaGetLastError().
int softmax_rows(const void* x, void* out, long long m, int d, int dtype, TsdivSeedTable table,
                 int n_iters, int schedule, cudaStream_t stream) {
  return dtype == 0 ? launch<float>(x, out, m, d, table, n_iters, schedule, stream)
                    : launch<__nv_bfloat16>(x, out, m, d, table, n_iters, schedule, stream);
}

}  // extern "C"
