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
// The arithmetic is a few dozen f32 operations per element, below the
// card's f32 rate per byte, so the least time is bytes / HBM bandwidth; the
// bodies' instruction count is what keeps them above it.
//
// Design: a flat contiguous f32 buffer, with bounds checks in place of the
// TPU kernels' ragged-tile masking (the body is elementwise, so the layout
// cannot change the bits). All three run one grid-stride kernel: four
// elements per thread with 16-byte loads and stores when every pointer is
// 16-byte aligned, and a scalar loop for the tail and for misaligned views.
// Each block first copies the seed table into shared memory, where the
// segment select indexes it without serialising on divergent constant-cache
// addresses (a warp's lanes fall in different segments); the grid holds no
// more blocks than are resident at once, so the copy is paid once per
// resident block. Rsqrt's usual Newton step count (2) is compiled in. Each
// launch function returns the cudaGetLastError() of its launch.
#include <cuda_runtime.h>

#include "launch.cuh"
#include "tsdiv_body.cuh"

namespace {

constexpr int kThreads = 256;

// The element operations: one output from one or two inputs and the block's
// copy of the table.
struct RecipOp {
  int n_iters, schedule;
  __device__ float operator()(float x, float, const TsdivSeedTable& t) const {
    return tsdiv::recip_f32_bits(x, t, n_iters, schedule);
  }
};

struct DivideOp {
  int n_iters, schedule;
  __device__ float operator()(float a, float b, const TsdivSeedTable& t) const {
    return tsdiv::divide_f32_bits(a, b, t, n_iters, schedule);
  }
};

// kNewton >= 0 fixes the Newton steps at compile time (the loops unroll);
// -1 takes them from newton_iters.
template <int kNewton>
struct RsqrtOp {
  int newton_iters;
  __device__ float operator()(float x, float, const TsdivSeedTable& t) const {
    return tsdiv::rsqrt_f32_bits(x, t, kNewton >= 0 ? kNewton : newton_iters);
  }
};

// out[i] = op(a[i], b[i]) (b is read only when kBinary).
template <bool kBinary, class Op>
__global__ void __launch_bounds__(kThreads)
    elementwise_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       float* __restrict__ out, long long n,
                       const __grid_constant__ TsdivSeedTable table, Op op) {
  __shared__ TsdivSeedTable t;
  tsdiv::stage_table(&t, table);
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(out) |
                         (kBinary ? reinterpret_cast<uintptr_t>(b) : 0);
  const long long n4 = (addr & 15) == 0 ? n / 4 : 0;
  for (long long i = tid; i < n4; i += stride) {
    const float4 x = reinterpret_cast<const float4*>(a)[i];
    const float4 y = kBinary ? reinterpret_cast<const float4*>(b)[i] : x;
    float4 r;
    r.x = op(x.x, y.x, t);
    r.y = op(x.y, y.y, t);
    r.z = op(x.z, y.z, t);
    r.w = op(x.w, y.w, t);
    reinterpret_cast<float4*>(out)[i] = r;
  }
  for (long long i = 4 * n4 + tid; i < n; i += stride)
    out[i] = op(a[i], kBinary ? b[i] : 0.0f, t);
}

// Launches the grid-stride loop with enough blocks for four elements a
// thread, at most as many as the current device holds resident at once.
template <bool kBinary, class Op>
int launch(const float* a, const float* b, float* out, long long n,
           const TsdivSeedTable& table, Op op, cudaStream_t stream) {
  unsigned int blocks = 0;
  const cudaError_t err =
      grid_stride_blocks(elementwise_kernel<kBinary, Op>, kThreads, 4, n, &blocks);
  if (err != cudaSuccess) return (int)err;
  elementwise_kernel<kBinary, Op><<<blocks, kThreads, 0, stream>>>(a, b, out, n, table, op);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tsdiv_recip_f32(const float* x, float* out, long long n, TsdivSeedTable table, int n_iters,
                    int schedule, cudaStream_t stream) {
  return launch<false>(x, nullptr, out, n, table, RecipOp{n_iters, schedule}, stream);
}

int tsdiv_divide_f32(const float* a, const float* b, float* out, long long n,
                     TsdivSeedTable table, int n_iters, int schedule, cudaStream_t stream) {
  return launch<true>(a, b, out, n, table, DivideOp{n_iters, schedule}, stream);
}

int tsdiv_rsqrt_f32(const float* x, float* out, long long n, TsdivSeedTable table,
                    int newton_iters, cudaStream_t stream) {
  if (newton_iters == 2) return launch<false>(x, nullptr, out, n, table, RsqrtOp<2>{2}, stream);
  return launch<false>(x, nullptr, out, n, table, RsqrtOp<-1>{newton_iters}, stream);
}

}  // extern "C"
