// Hopper kernels of the fused division unit, with a plain C interface for
// ctypes (built by kernels/_build.py with nvcc -fmad=false for sm_90a).
//
// Replaces the reference's Pallas TPU kernels in src/repro/kernels/tsdiv.py:
//   tsdiv_divide_f32 <- tsdiv_divide_tiled_2d / _divide_tiled_kernel and
//                       tsdiv_divide_2d / _divide_kernel
//   tsdiv_recip_f32  <- tsdiv_recip_2d / _recip_kernel and
//                       tsdiv_recip_tiled_2d / _recip_tiled_kernel
//   tsdiv_rsqrt_f32  <- tsdiv_rsqrt_2d / _rsqrt_kernel and
//                       tsdiv_rsqrt_tiled_2d / _rsqrt_tiled_kernel
//
// Bound: each is elementwise and memory-bound on the card. Divide moves
// 12 bytes per element (two f32 reads, one write); recip and rsqrt move 8.
// The arithmetic is a few dozen f32 operations per element, far below the
// card's f32 rate per byte, so the least time is bytes / HBM bandwidth.
//
// Design: one thread per element over a flat contiguous f32 buffer, with a
// bounds check in place of the TPU kernels' ragged-tile masking (the body is
// elementwise, so the layout cannot change the bits). The seed table rides in
// the kernel's parameter space. Each launch function returns the
// cudaGetLastError() of its launch.
#include <cuda_runtime.h>

#include "tsdiv_body.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void recip_kernel(const float* __restrict__ x, float* __restrict__ out, long long n,
                             const TsdivSeedTable table, int n_iters, int schedule) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = tsdiv::recip_f32_bits(x[i], table, n_iters, schedule);
}

__global__ void divide_kernel(const float* __restrict__ a, const float* __restrict__ b,
                              float* __restrict__ out, long long n, const TsdivSeedTable table,
                              int n_iters, int schedule) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = tsdiv::divide_f32_bits(a[i], b[i], table, n_iters, schedule);
}

__global__ void rsqrt_kernel(const float* __restrict__ x, float* __restrict__ out, long long n,
                             const TsdivSeedTable table, int newton_iters) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = tsdiv::rsqrt_f32_bits(x[i], table, newton_iters);
}

unsigned int blocks_for(long long n) { return (unsigned int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

int tsdiv_recip_f32(const float* x, float* out, long long n, TsdivSeedTable table, int n_iters,
                    int schedule, cudaStream_t stream) {
  recip_kernel<<<blocks_for(n), kThreads, 0, stream>>>(x, out, n, table, n_iters, schedule);
  return (int)cudaGetLastError();
}

int tsdiv_divide_f32(const float* a, const float* b, float* out, long long n,
                     TsdivSeedTable table, int n_iters, int schedule, cudaStream_t stream) {
  divide_kernel<<<blocks_for(n), kThreads, 0, stream>>>(a, b, out, n, table, n_iters, schedule);
  return (int)cudaGetLastError();
}

int tsdiv_rsqrt_f32(const float* x, float* out, long long n, TsdivSeedTable table,
                    int newton_iters, cudaStream_t stream) {
  rsqrt_kernel<<<blocks_for(n), kThreads, 0, stream>>>(x, out, n, table, newton_iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
