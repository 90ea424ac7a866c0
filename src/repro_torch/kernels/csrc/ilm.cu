// Hopper kernels of the Iterative Logarithmic Multiplier and squarer on
// uint32 lanes, with a plain C interface for ctypes (built by
// kernels/_build.py with nvcc -fmad=false for sm_90a).
//
// Replaces the reference's Pallas TPU kernels in src/repro/kernels/ilm.py:
//   ilm_mul_u32    <- ilm_mul_2d / _ilm_mul_kernel
//   ilm_square_u32 <- ilm_square_2d / _ilm_square_kernel
//
// Neither kernel runs the reference's stages. A stage of the multiplier
// finds the leading ones of x = 2^k1 + rx and y = 2^k2 + ry (the priority
// encoder), adds 2^(k1+k2) + rx*2^k2 + ry*2^k1 = x*y - rx*ry (mod 2^32: a
// shift by 32 or more gives 0 in the reference, which is the product mod
// 2^32) and carries rx, ry on, while both are non-zero, at most `iters`
// stages. So the sum telescopes: after the loop
//
//   ilm_mul(x, y, iters) = x*y - rx*ry  (mod 2^32),
//
// where rx (ry) is x (y) with its top `iters` set bits cleared. When the
// loop stops early because an operand reaches 0, that operand has at most
// `iters` set bits, so its residue is 0 and so is the product term. The
// squarer is the case y = x: x*x - r*r. Both hold for every uint32 operand,
// wrap included: tests/test_torch_ilm.py holds them against the
// reference's kernels over all of uint32 at iters 1 to 32, the card tests
// hold these kernels against the stage loop (the plain versions) at each
// of them. So a lane costs a population count and one multiply per operand
// when popcount <= iters (every 16-bit operand at the main path's iters
// 16); otherwise the residue is found by clearing the leading one `iters`
// times (one trip count for every such lane of a warp).
// Bound: the 12 (multiplier) or 8 (squarer) bytes a lane moves, at 16-bit
// operands and iters >= 4 (chip_smoke.py counts the operations; the stage
// loop these kernels replaced ran ~15 integer instructions a stage).
// Launch: tsdiv.cu's grid-stride loop, four lanes a thread with 16-byte
// accesses when every pointer is 16-byte aligned, a scalar tail and
// misaligned views on the scalar loop (launch.cuh sizes the grid).
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;

// x with its top `iters` set bits cleared (0 when popcount(x) <= iters).
__device__ __forceinline__ uint32_t residue(uint32_t x, int iters) {
  if (__popc(x) <= iters) return 0u;
  uint32_t v = x;
  for (int s = 0; s < iters; ++s) v ^= 1u << (31 - __clz(v));   // clear the leading one
  return v;
}

__device__ __forceinline__ uint32_t ilm_mul_lane(uint32_t x, uint32_t y, int iters) {
  return x * y - residue(x, iters) * residue(y, iters);
}

__device__ __forceinline__ uint32_t ilm_square_lane(uint32_t x, int iters) {
  const uint32_t r = residue(x, iters);
  return x * x - r * r;
}

__global__ void __launch_bounds__(kThreads)
    ilm_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                   uint32_t* __restrict__ out, long long n, int iters) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(out);
  const long long n4 = (addr & 15) == 0 ? n / 4 : 0;
  for (long long i = tid; i < n4; i += stride) {
    const uint4 x = reinterpret_cast<const uint4*>(a)[i];
    const uint4 y = reinterpret_cast<const uint4*>(b)[i];
    reinterpret_cast<uint4*>(out)[i] =
        make_uint4(ilm_mul_lane(x.x, y.x, iters), ilm_mul_lane(x.y, y.y, iters),
                   ilm_mul_lane(x.z, y.z, iters), ilm_mul_lane(x.w, y.w, iters));
  }
  for (long long i = 4 * n4 + tid; i < n; i += stride) out[i] = ilm_mul_lane(a[i], b[i], iters);
}

__global__ void __launch_bounds__(kThreads)
    ilm_square_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out, long long n,
                      int iters) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(out);
  const long long n4 = (addr & 15) == 0 ? n / 4 : 0;
  for (long long i = tid; i < n4; i += stride) {
    const uint4 x = reinterpret_cast<const uint4*>(a)[i];
    reinterpret_cast<uint4*>(out)[i] =
        make_uint4(ilm_square_lane(x.x, iters), ilm_square_lane(x.y, iters),
                   ilm_square_lane(x.z, iters), ilm_square_lane(x.w, iters));
  }
  for (long long i = 4 * n4 + tid; i < n; i += stride) out[i] = ilm_square_lane(a[i], iters);
}

}  // namespace

extern "C" {

// a, b, out: n contiguous uint32 lanes. Returns the launch's cudaGetLastError().
int ilm_mul_u32(const uint32_t* a, const uint32_t* b, uint32_t* out, long long n, int iters,
                cudaStream_t stream) {
  unsigned int blocks = 0;
  const cudaError_t err = grid_stride_blocks(ilm_mul_kernel, kThreads, 4, n, &blocks);
  if (err != cudaSuccess) return (int)err;
  ilm_mul_kernel<<<blocks, kThreads, 0, stream>>>(a, b, out, n, iters);
  return (int)cudaGetLastError();
}

int ilm_square_u32(const uint32_t* a, uint32_t* out, long long n, int iters, cudaStream_t stream) {
  unsigned int blocks = 0;
  const cudaError_t err = grid_stride_blocks(ilm_square_kernel, kThreads, 4, n, &blocks);
  if (err != cudaSuccess) return (int)err;
  ilm_square_kernel<<<blocks, kThreads, 0, stream>>>(a, out, n, iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
