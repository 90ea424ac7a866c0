// Hopper kernels of the Iterative Logarithmic Multiplier and squarer on
// uint32 lanes, with a plain C interface for ctypes (built by
// kernels/_build.py with nvcc -fmad=false for sm_90a).
//
// Replaces the reference's Pallas TPU kernels in src/repro/kernels/ilm.py:
//   ilm_mul_u32    <- ilm_mul_2d / _ilm_mul_kernel
//   ilm_square_u32 <- ilm_square_2d / _ilm_square_kernel
//
// Each stage of the multiplier finds the leading ones k1, k2 (the priority
// encoder), clears them (the residues ra, rb) and adds
// 2^(k1+k2) + ra*2^k2 + rb*2^k1; the squarer adds 2^(2k) + r*2^(k+1). A
// stage runs while both residues (the squarer's one) are non-zero, at most
// `iters` stages. Everything is uint32 arithmetic mod 2^32, and a shift by
// 32 or more gives 0, as in the reference.
//
// Bound: integer operations for 16-bit operands. A multiplier stage is ~15
// integer instructions (two leading-zero counts, two shifts for the leading
// ones, two subtracts, three shifts and two adds for the partial product,
// the accumulate and the loop tests) against 12 bytes moved per lane, and
// random 16-bit operands run ~6-7 stages, so the instruction count outweighs
// the bytes at the card's integer rate.
//
// Design: one thread per lane over a flat contiguous buffer, in place of the
// TPU's (256, 256) blocks (the body is elementwise, so the layout cannot
// change the bits). The priority encoder is 31 - __clz(v), which gives the
// reference's bit-smear + popcount integers. A lane stops at its first
// invalid stage: such a stage changes nothing, so stopping early is the same
// function with fewer instructions.
#include <cuda_runtime.h>
#include <stdint.h>

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

__global__ void ilm_square_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
                                  long long n, int iters) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x = a[i], acc = 0u;
  for (int s = 0; s < iters && x != 0u; ++s) {
    const uint32_t k = lead(x);
    const uint32_t r = x - (1u << k);
    acc += shl(1u, k + k) + shl(r, k + 1u);
    x = r;
  }
  out[i] = acc;
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
  ilm_square_kernel<<<blocks_for(n), kThreads, 0, stream>>>(a, out, n, iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
