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
// per f32 element, 4 per bf16), against ~14 f32 operations per element
// (exp included), far below the card's f32 rate per byte.
//
// Design: one row a block, no padding. Lane l of a warp holds elements
// c*256 + 8l ... c*256 + 8l + 7 of each 256-element chunk c (a rows::Group:
// one 16-byte load in bf16, two in f32; -inf past the row's end, which is
// neutral for the max and whose exp is the +0 the sum's order pads with).
// Held rows are loaded whole before the first use and stay in registers:
// the row is read from device memory once and exp runs once per element.
// Where rows are many (prefill), a row of up to kMaxHeld chunks takes one
// warp, with no shared memory and no barrier. Where rows are few (a decode
// step's), one warp would run the row's work as one long chain, so a row of
// kSplitMin to kMaxSplitHeld chunks takes kSplit warps: warp q holds chunks
// q, q + kSplit, ..., the max meets in shared memory, and warp 0 adds the
// exps in chunk order. The max is a shuffle tree; the sum is
// rows::warp_tree_sum, the plain version's common.row_sum order bit for
// bit. Lane 0 computes the reciprocal (one recip_f32_bits a row, not one a
// thread) and gives it to the row's lanes. Other rows take one warp and are
// read three times (max, exp and sum, scale) in the same layout; rows whose
// length is not a multiple of 8 elements, or whose x or out base is not
// 16-byte aligned, take that loop with scalar accesses.
//
// The split softmax (softmax_split_*): a row whose elements lie on several
// ranks (a decode cache split by sequence), in three launches with the
// ranks' all-reduces between them: the row's max; exp(x - M) with M the
// max over the ranks, written out, and its row sum in the fused kernel's
// order; ex * (1/S) with S the sum over the ranks, the reciprocal through
// recip_f32_bits. On one rank the three give the fused kernel's bits. f32
// rows of any length, one row a block of 256 threads for the max and the
// sum: thread t adds the row's elements t, t + 256, ... in sequence (the
// order's thread t) and the block's warp 0 finishes with
// rows::warp_tree_sum; the scale takes a block per 2048 elements of a row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"
#include "tsdiv_body.cuh"

namespace {

constexpr int kSplit = 8;                    // warps a row where rows are few
constexpr int kChunk = rows::kThreads;       // elements per chunk of the order
constexpr int kPer = rows::kPerLane;         // elements a lane holds per chunk (8)
constexpr int kMaxHeld = 9;                  // chunks one warp holds: d <= 2304
constexpr int kMaxSplitHeld = 32;            // chunks kSplit warps hold: d <= 8192
constexpr int kSplitMin = 2;                 // fewest chunks a split row has

// Rows an SM up to which a row of `chunks` chunks takes kSplit warps: 4 for
// a held row of fewer than kSplit chunks (some warps hold none), 8 for a
// longer held row, 32 for a row one warp would read three times (the
// crossovers measured by tools/softmax_split_ab.py; PERF.md, PR 17).
inline long long split_rows(int chunks) {
  return chunks > kMaxHeld ? 32 : chunks >= kSplit ? 8 : 4;
}

template <typename T>
__device__ __forceinline__ float group_max(float m, const rows::Group<T>& g) {
#pragma unroll
  for (int j = 0; j < kPer; ++j) m = rows::nan_max(m, g.get(j));
  return m;
}

// ex = exp(x - mfin) of one group.
template <typename T>
__device__ __forceinline__ void exps(float (&ex)[kPer], const rows::Group<T>& g, float mfin) {
#pragma unroll
  for (int j = 0; j < kPer; ++j) ex[j] = expf(__fsub_rn(g.get(j), mfin));
}

__device__ __forceinline__ void add(float (&p)[kPer], const float (&ex)[kPer]) {
#pragma unroll
  for (int j = 0; j < kPer; ++j) p[j] = __fadd_rn(p[j], ex[j]);
}

// out = ex * (1/sum) (0 where the sum is 0) for n = d - e > 0 elements at p.
template <typename T, bool kVec>
__device__ __forceinline__ void scale(const float (&ex)[kPer], float s, float rs, T* p, int n) {
  float o[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) o[j] = s == 0.0f ? 0.0f : __fmul_rn(ex[j], rs);
  rows::Group<T> g;
  g.put(o);
  g.template store<kVec>(p, n);
}

// One row a block. kHeld > 0: rows of at most kHeld chunks, held in
// registers by kParts warps, warp q holding chunks q, q + kParts, ...; with
// kParts > 1 the warps meet in shared memory for the max (red_sh), and warp
// 0 adds the others' exps in chunk order (ex_sh: the row's exps, chunks *
// kChunk floats of dynamic shared memory); 3 barriers. kHeld = 0: any
// length, one warp, read three times.
template <typename T, bool kVec, int kHeld, int kParts>
__global__ void __launch_bounds__(kSplit * 32)
    softmax_kernel(const T* __restrict__ x, T* __restrict__ out, int d,
                   const __grid_constant__ TsdivSeedTable table, int n_iters, int schedule) {
  static_assert(kParts == 1 || kHeld > 0, "only a held row is split");
  constexpr int kMine = kHeld > 0 ? (kHeld + kParts - 1) / kParts : 1;   // chunks a warp holds
  extern __shared__ __align__(16) float ex_sh[];
  __shared__ float red_sh[kParts > 1 ? kParts : 1];
  const int part = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T* xr = x + (long long)blockIdx.x * d;
  T* orow = out + (long long)blockIdx.x * d;
  const int chunks = (d + kChunk - 1) / kChunk;
  const int e0 = kPer * lane;   // the lane's offset in every chunk
  float mx = -INFINITY;
  rows::Group<T> held[kMine];
  if (kHeld > 0) {
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      const int c = part + kParts * i;
      if (c < chunks)
        held[i].template load<kVec>(xr + c * kChunk + e0, d - c * kChunk - e0, -INFINITY);
    }
#pragma unroll
    for (int i = 0; i < kMine; ++i)
      if (part + kParts * i < chunks) mx = group_max(mx, held[i]);
  } else {
    for (int c = 0; c < chunks; ++c) {
      rows::Group<T> g;
      g.template load<kVec>(xr + c * kChunk + e0, d - c * kChunk - e0, -INFINITY);
      mx = group_max(mx, g);
    }
  }
  mx = rows::warp_max(mx);
  if (kParts > 1) {
    if (lane == 0) red_sh[part] = mx;
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kParts; ++q) mx = rows::nan_max(mx, red_sh[q]);
  }
  const float mfin = isfinite(mx) ? mx : 0.0f;
  float p[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) p[j] = 0.0f;
  float ex[kMine][kPer];
  if (kHeld > 0) {
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      const int c = part + kParts * i;
      if (c >= chunks) continue;
      exps(ex[i], held[i], mfin);
      if (kParts == 1) {
        add(p, ex[i]);
      } else {
        float4* sh = reinterpret_cast<float4*>(ex_sh + c * kChunk + e0);
        sh[0] = make_float4(ex[i][0], ex[i][1], ex[i][2], ex[i][3]);
        sh[1] = make_float4(ex[i][4], ex[i][5], ex[i][6], ex[i][7]);
      }
    }
    if (kParts > 1) {
      __syncthreads();
      if (part == 0) {
        for (int c = 0; c < chunks; ++c) {
          const float4* sh = reinterpret_cast<const float4*>(ex_sh + c * kChunk + e0);
          const float4 a = sh[0], b = sh[1];
          const float e[kPer] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
          add(p, e);
        }
      }
    }
  } else {
    for (int c = 0; c < chunks; ++c) {
      rows::Group<T> g;
      g.template load<kVec>(xr + c * kChunk + e0, d - c * kChunk - e0, -INFINITY);
      exps(ex[0], g, mfin);
      add(p, ex[0]);
    }
  }
  float s = 0.0f, rs = 0.0f;
  if (part == 0) {
    s = rows::warp_tree_sum(p);
    if (lane == 0) rs = tsdiv::recip_f32_bits(s, table, n_iters, schedule);
  }
  if (kParts == 1) {
    s = __shfl_sync(0xFFFFFFFFu, s, 0);
    rs = __shfl_sync(0xFFFFFFFFu, rs, 0);
  } else {
    if (part == 0 && lane == 0) red_sh[0] = s, red_sh[1] = rs;   // every max is read
    __syncthreads();
    s = red_sh[0];
    rs = red_sh[1];
  }
  if (kHeld > 0) {
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      const int c = part + kParts * i;
      const int e = c * kChunk + e0;
      if (c < chunks && e < d) scale<T, kVec>(ex[i], s, rs, orow + e, d - e);
    }
  } else {
    for (int c = 0; c < chunks; ++c) {
      const int e = c * kChunk + e0;
      if (e >= d) break;
      rows::Group<T> g;
      g.template load<kVec>(xr + e, d - e, -INFINITY);
      exps(ex[0], g, mfin);
      scale<T, kVec>(ex[0], s, rs, orow + e, d - e);
    }
  }
}

template <typename T, bool kVec, int kHeld, int kParts>
int launch_shaped(const void* x, void* out, long long m, int d, const TsdivSeedTable& table,
                  int n_iters, int schedule, cudaStream_t stream) {
  const size_t shared = kParts > 1 ? sizeof(float) * kChunk * ((d + kChunk - 1) / kChunk) : 0;
  softmax_kernel<T, kVec, kHeld, kParts><<<(unsigned int)m, kParts * 32, shared, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), d, table, n_iters, schedule);
  return (int)cudaGetLastError();
}

// The vector path where both bases are 16-byte aligned and d is a multiple
// of 8 (so is every row's start), the scalar path otherwise. A vector row
// takes kSplit warps where the rule above says so, else one warp, held in
// registers up to kMaxHeld chunks and read three times past that.
template <typename T>
int launch(const void* x, void* out, long long m, int d, const TsdivSeedTable& table,
           int n_iters, int schedule, cudaStream_t stream) {
  if (m > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  const int chunks = (d + kChunk - 1) / kChunk;
  if (d % kPer != 0 || (addr & 15) != 0)
    return launch_shaped<T, false, 0, 1>(x, out, m, d, table, n_iters, schedule, stream);
  if (chunks <= kMaxSplitHeld) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (chunks >= kSplitMin && m <= split_rows(chunks) * sms) {
      // Two instantiations: the shorter one's fewer registers fit 4 blocks an SM.
      if (chunks <= kMaxHeld)
        return launch_shaped<T, true, kMaxHeld, kSplit>(x, out, m, d, table, n_iters, schedule,
                                                        stream);
      return launch_shaped<T, true, kMaxSplitHeld, kSplit>(x, out, m, d, table, n_iters,
                                                           schedule, stream);
    }
  }
  if (chunks <= kMaxHeld)
    return launch_shaped<T, true, kMaxHeld, 1>(x, out, m, d, table, n_iters, schedule, stream);
  return launch_shaped<T, true, 0, 1>(x, out, m, d, table, n_iters, schedule, stream);
}

constexpr int kRowThreads = rows::kThreads;    // the split passes' block: thread t = order's t
constexpr int kScaleSpan = kRowThreads * 8;     // elements of a row one scale block covers

__global__ void __launch_bounds__(kRowThreads)
    split_max_kernel(const float* __restrict__ x, float* __restrict__ mx, int d) {
  __shared__ float red_sh[kRowThreads / 32];
  const float* xr = x + (long long)blockIdx.x * d;
  float m = -INFINITY;
#pragma unroll 8
  for (int i = threadIdx.x; i < d; i += kRowThreads) m = rows::nan_max(m, xr[i]);
  m = rows::warp_max(m);
  if ((threadIdx.x & 31) == 0) red_sh[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < kRowThreads / 32; ++q) m = rows::nan_max(m, red_sh[q]);
    mx[blockIdx.x] = m;
  }
}

__global__ void __launch_bounds__(kRowThreads)
    split_exp_kernel(const float* __restrict__ x, const float* __restrict__ top,
                     float* __restrict__ ex, float* __restrict__ sum, int d) {
  __shared__ float part_sh[kRowThreads];
  const long long off = (long long)blockIdx.x * d;
  const float t = top[blockIdx.x];
  const float mfin = isfinite(t) ? t : 0.0f;
  float acc = 0.0f;
#pragma unroll 8
  for (int i = threadIdx.x; i < d; i += kRowThreads) {
    const float v = expf(__fsub_rn(x[off + i], mfin));
    ex[off + i] = v;
    acc = __fadd_rn(acc, v);
  }
  part_sh[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    float p[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) p[j] = part_sh[kPer * threadIdx.x + j];
    const float s = rows::warp_tree_sum(p);
    if (threadIdx.x == 0) sum[blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kRowThreads)
    split_scale_kernel(const float* __restrict__ ex, const float* __restrict__ total,
                       float* __restrict__ out, long long m, int d,
                       const __grid_constant__ TsdivSeedTable table, int n_iters, int schedule) {
  __shared__ float rs_sh;
  const int lo = blockIdx.x * kScaleSpan;
  const int hi = min(d, lo + kScaleSpan);
  for (long long row = blockIdx.y; row < m; row += gridDim.y) {
    const float s = total[row];
    if (threadIdx.x == 0) rs_sh = tsdiv::recip_f32_bits(s, table, n_iters, schedule);
    __syncthreads();
    const float rs = rs_sh;
    const long long off = row * d;
    for (int i = lo + threadIdx.x; i < hi; i += kRowThreads)
      out[off + i] = s == 0.0f ? 0.0f : __fmul_rn(ex[off + i], rs);
    __syncthreads();   // rs_sh is rewritten for the next row
  }
}

}  // namespace

extern "C" {

// x, out: contiguous (m, d) rows; dtype 0 = f32, 1 = bf16. Returns the
// launch's cudaGetLastError() (cudaErrorInvalidValue for m >= 2^31).
int softmax_rows(const void* x, void* out, long long m, int d, int dtype, TsdivSeedTable table,
                 int n_iters, int schedule, cudaStream_t stream) {
  return dtype == 0 ? launch<float>(x, out, m, d, table, n_iters, schedule, stream)
                    : launch<__nv_bfloat16>(x, out, m, d, table, n_iters, schedule, stream);
}

// The split softmax's passes over contiguous (m, d) f32 rows (m < 2^31):
// mx (m) the rows' maxima; ex (m, d) = exp(x - top) and sum (m) its row
// sums, top (m) the maxima over the ranks; out (m, d) = ex * (1/total)
// (0 where total is 0), total (m) the sums over the ranks.
int softmax_split_max(const void* x, void* mx, long long m, int d, cudaStream_t stream) {
  if (m > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  split_max_kernel<<<(unsigned int)m, kRowThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(mx), d);
  return (int)cudaGetLastError();
}

int softmax_split_exp(const void* x, const void* top, void* ex, void* sum, long long m, int d,
                      cudaStream_t stream) {
  if (m > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  split_exp_kernel<<<(unsigned int)m, kRowThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(top), static_cast<float*>(ex),
      static_cast<float*>(sum), d);
  return (int)cudaGetLastError();
}

int softmax_split_scale(const void* ex, const void* total, void* out, long long m, int d,
                        TsdivSeedTable table, int n_iters, int schedule, cudaStream_t stream) {
  const dim3 grid((d + kScaleSpan - 1) / kScaleSpan, (unsigned int)(m < 65535 ? m : 65535));
  split_scale_kernel<<<grid, kRowThreads, 0, stream>>>(
      static_cast<const float*>(ex), static_cast<const float*>(total), static_cast<float*>(out),
      m, d, table, n_iters, schedule);
  return (int)cudaGetLastError();
}

}  // extern "C"
