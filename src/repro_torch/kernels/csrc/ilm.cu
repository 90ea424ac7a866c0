// Hopper kernels of the Iterative Logarithmic Multiplier and squarer on
// uint32 lanes, with a plain C interface for ctypes (built by
// kernels/_build.py with nvcc -fmad=false for sm_90a).
//
// Replaces the reference's Pallas TPU kernels in src/repro/kernels/ilm.py:
//   ilm_mul_u32    <- ilm_mul_2d / _ilm_mul_kernel
//   ilm_square_u32 <- ilm_square_2d / _ilm_square_kernel
//
// The multiplier runs the reference's stages: each finds the leading ones
// k1, k2 (the priority encoder), clears them (the residues ra, rb) and adds
// 2^(k1+k2) + ra*2^k2 + rb*2^k1, while both residues are non-zero, at most
// `iters` stages. A stage is ~15 integer instructions (two leading-zero
// counts, two shifts for the leading ones, two subtracts, three shifts and
// two adds for the partial product, the accumulate and the loop tests)
// against 12 bytes moved per lane, so it is bound by integer operations.
// One thread per lane; the priority encoder is 31 - __clz(v), which gives
// the reference's bit-smear + popcount integers; a lane stops at its first
// invalid stage, which would change nothing.
//
// The squarer does not run the stages. A stage turns x = 2^k + r into
// acc += 2^(2k) + r*2^(k+1) = x^2 - r^2 (mod 2^32: a shift by 32 or more
// gives 0 in the reference, which is the product mod 2^32) and carries r
// on, so the sum telescopes: after the loop
//
//   ilm_square(x, iters) = x*x - r*r  (mod 2^32),
//
// where r is x with its top `iters` set bits cleared (the loop also stops
// when x reaches 0, so r = 0 when popcount(x) <= iters). This holds for
// every uint32 operand, wrap included: tests/test_torch_ilm.py holds it
// against the reference's kernel over all of uint32 at iters 1 to 32, the
// card tests hold this kernel against the stage loop at each of them. So a
// lane costs a population count and one multiply when popcount(x) <= iters
// (every 16-bit operand at the main path's iters 16); otherwise r is found
// by the shorter of two loops: clear the leading one `iters` times, or keep
// the lowest popcount - iters set bits (clear the lowest one that many
// times and take what was cleared). Bound: the 8 bytes a lane moves, at
// 16-bit operands and iters >= 4 (chip_smoke.py counts the operations).
// Launch: tsdiv.cu's grid-stride loop, four lanes a thread with 16-byte
// accesses when both pointers are 16-byte aligned, a scalar tail and
// misaligned views on the scalar loop (launch.cuh sizes the grid).
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t shl(uint32_t v, uint32_t k) { return k < 32u ? v << k : 0u; }

__device__ __forceinline__ uint32_t lead(uint32_t v) { return 31u - (uint32_t)__clz(v); }

__global__ void ilm_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                               uint32_t* __restrict__ out, long long n, int iters) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x = a[i], y = b[i], acc = 0u;
  for (int s = 0; s < iters && x != 0u && y != 0u; ++s) {
    const uint32_t k1 = lead(x), k2 = lead(y);
    const uint32_t rx = x - (1u << k1), ry = y - (1u << k2);
    acc += shl(1u, k1 + k2) + shl(rx, k2) + shl(ry, k1);
    x = rx;
    y = ry;
  }
  out[i] = acc;
}

// x with its top `iters` set bits cleared (0 when popcount(x) <= iters).
__device__ __forceinline__ uint32_t residue(uint32_t x, int iters) {
  const int keep = __popc(x) - iters;   // the low set bits that stay
  if (keep <= 0) return 0u;
  uint32_t v = x;
  if (keep < iters) {
    for (int s = 0; s < keep; ++s) v &= v - 1u;   // clear the lowest one
    return x ^ v;
  }
  for (int s = 0; s < iters; ++s) v &= 0x7FFFFFFFu >> __clz(v);   // clear the leading one
  return v;
}

__device__ __forceinline__ uint32_t ilm_square_lane(uint32_t x, int iters) {
  const uint32_t r = residue(x, iters);
  return x * x - r * r;
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

unsigned int blocks_for(long long n) { return (unsigned int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// a, b, out: n contiguous uint32 lanes. Returns the launch's cudaGetLastError().
int ilm_mul_u32(const uint32_t* a, const uint32_t* b, uint32_t* out, long long n, int iters,
                cudaStream_t stream) {
  ilm_mul_kernel<<<blocks_for(n), kThreads, 0, stream>>>(a, b, out, n, iters);
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
