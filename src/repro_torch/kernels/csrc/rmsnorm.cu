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
// element, 8 per f32) plus w, against ~6 f32 operations per element. A row
// is short (768 elements at paper_fpdiv's width, 2048 at tinyllama's), so a
// block per row spends its time on barriers, not bytes.
//
// Design: one warp per row, kWarps rows per block, no shared memory and no
// barrier. Lane l holds elements c*256 + 8l ... c*256 + 8l + 7 of each
// 256-element chunk c: the partials of threads 8l ... 8l + 7 of rows.cuh's
// order, so the sum of squares is that order's additions
// (rows::warp_tree_sum) and equals the plain version's common.row_sum bit
// for bit. A lane's 8 elements (a rows::Group, 0 past the row's end) are
// one 16-byte load in bf16 (two in f32).
// Rows of up to kMaxHeld chunks stay in registers between the sum and the
// scale; longer rows are read again. Lane 0 computes the rsqrt and
// shuffles it to the warp. w is read in its own type (f32 or bf16; the
// upcast is exact). Rows whose length is not a multiple of 8 elements, or
// whose x, w or out base is not 16-byte aligned, take the same loop with
// scalar accesses.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"
#include "tsdiv_body.cuh"

namespace {

constexpr int kWarps = 8;                    // rows per block
constexpr int kChunk = rows::kThreads;       // elements per chunk of the order
constexpr int kPer = rows::kPerLane;         // elements a lane holds per chunk (8)
constexpr int kMaxHeld = 8;                  // chunks kept in registers: d <= 2048

template <typename T>
__device__ __forceinline__ void add_squares(float (&p)[kPer], const rows::Group<T>& g) {
#pragma unroll
  for (int j = 0; j < kPer; ++j) p[j] = __fadd_rn(p[j], __fmul_rn(g.get(j), g.get(j)));
}

// out = (x * r) * w for one lane's group at row offset e (n = d - e > 0).
template <typename T, bool kVec>
__device__ __forceinline__ void scale(const rows::Group<T>& x, float r, const void* w, bool w_bf16,
                                      T* out, int e, int n) {
  float wv[kPer];
  if (w_bf16) {
    rows::Group<__nv_bfloat16> g;
    g.load<kVec>(static_cast<const __nv_bfloat16*>(w) + e, n, 0.0f);
#pragma unroll
    for (int j = 0; j < kPer; ++j) wv[j] = g.get(j);
  } else {
    rows::Group<float> g;
    g.load<kVec>(static_cast<const float*>(w) + e, n, 0.0f);
#pragma unroll
    for (int j = 0; j < kPer; ++j) wv[j] = g.get(j);
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) wv[j] = __fmul_rn(__fmul_rn(x.get(j), r), wv[j]);
  rows::Group<T> o;
  o.put(wv);
  o.template store<kVec>(out + e, n);
}

// kHeld > 0: rows of at most kHeld chunks, held in registers; 0: any
// length, read twice.
template <typename T, bool kVec, int kHeld>
__global__ void __launch_bounds__(kWarps * 32)
    rmsnorm_kernel(const T* __restrict__ x, const void* __restrict__ w, int w_bf16,
                   T* __restrict__ out, long long m, int d, float inv_d, float eps,
                   const __grid_constant__ TsdivSeedTable table, int newton_iters) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= m) return;   // the whole warp: no lane is left out of a shuffle
  const int lane = threadIdx.x & 31;
  const T* xr = x + row * d;
  T* orow = out + row * d;
  const int chunks = (d + kChunk - 1) / kChunk;
  float p[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) p[j] = 0.0f;
  rows::Group<T> held[kHeld > 0 ? kHeld : 1];
  if (kHeld > 0) {
#pragma unroll
    for (int c = 0; c < kHeld; ++c)
      if (c < chunks) held[c].template load<kVec>(xr + c * kChunk + kPer * lane,
                                                  d - c * kChunk - kPer * lane, 0.0f);
#pragma unroll
    for (int c = 0; c < kHeld; ++c)
      if (c < chunks) add_squares(p, held[c]);
  } else {
    for (int c = 0; c < chunks; ++c) {
      rows::Group<T> g;
      g.template load<kVec>(xr + c * kChunk + kPer * lane, d - c * kChunk - kPer * lane, 0.0f);
      add_squares(p, g);
    }
  }
  const float ss = rows::warp_tree_sum(p);
  float r = 0.0f;
  if (lane == 0) {
    const float se = __fmaf_rn(ss, inv_d, eps);
    r = tsdiv::rsqrt_f32(se, table, newton_iters);
    if (isinf(se)) r = 0.0f;
    if (isnan(se)) r = __uint_as_float(tsdiv::kNanBits);
  }
  r = __shfl_sync(0xFFFFFFFFu, r, 0);
  if (kHeld > 0) {
#pragma unroll
    for (int c = 0; c < kHeld; ++c) {
      const int e = c * kChunk + kPer * lane;
      if (c < chunks && e < d) scale<T, kVec>(held[c], r, w, w_bf16, orow, e, d - e);
    }
  } else {
    for (int c = 0; c < chunks; ++c) {
      const int e = c * kChunk + kPer * lane;
      if (e >= d) break;
      rows::Group<T> g;
      g.template load<kVec>(xr + e, d - e, 0.0f);
      scale<T, kVec>(g, r, w, w_bf16, orow, e, d - e);
    }
  }
}

template <typename T, bool kVec, int kHeld>
int launch_held(const void* x, const void* w, int w_bf16, void* out, long long m, int d,
                float inv_d, float eps, const TsdivSeedTable& table, int newton_iters,
                cudaStream_t stream) {
  const unsigned int blocks = (unsigned int)((m + kWarps - 1) / kWarps);
  rmsnorm_kernel<T, kVec, kHeld><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), w, w_bf16, static_cast<T*>(out), m, d, inv_d, eps, table,
      newton_iters);
  return (int)cudaGetLastError();
}

// The vector path where every row and w start on a 16-byte boundary, the
// row held in registers up to paper_fpdiv's d = 768 (3 chunks) or
// kMaxHeld chunks, read twice past that; the scalar path otherwise.
template <typename T>
int launch(const void* x, const void* w, int w_bf16, void* out, long long m, int d, float inv_d,
           float eps, const TsdivSeedTable& table, int newton_iters, cudaStream_t stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(out);
  if (d % kPer != 0 || (addr & 15) != 0)
    return launch_held<T, false, 0>(x, w, w_bf16, out, m, d, inv_d, eps, table, newton_iters,
                                    stream);
  const int chunks = (d + kChunk - 1) / kChunk;
  if (chunks <= 3)
    return launch_held<T, true, 3>(x, w, w_bf16, out, m, d, inv_d, eps, table, newton_iters,
                                   stream);
  if (chunks <= kMaxHeld)
    return launch_held<T, true, kMaxHeld>(x, w, w_bf16, out, m, d, inv_d, eps, table,
                                          newton_iters, stream);
  return launch_held<T, true, 0>(x, w, w_bf16, out, m, d, inv_d, eps, table, newton_iters,
                                 stream);
}

}  // namespace

extern "C" {

// x, out: contiguous (m, d) rows; w: (d,) contiguous. dtype / w_dtype: 0 =
// f32, 1 = bf16. Returns the launch's cudaGetLastError().
int rmsnorm_rows(const void* x, const void* w, void* out, long long m, int d, int dtype,
                 int w_dtype, float inv_d, float eps, TsdivSeedTable table, int newton_iters,
                 cudaStream_t stream) {
  return dtype == 0
             ? launch<float>(x, w, w_dtype, out, m, d, inv_d, eps, table, newton_iters, stream)
             : launch<__nv_bfloat16>(x, w, w_dtype, out, m, d, inv_d, eps, table, newton_iters,
                                     stream);
}

}  // extern "C"
