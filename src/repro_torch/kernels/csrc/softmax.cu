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
// rows of any length; float4 accesses where d % 4 == 0 and the bases are
// 16-byte aligned, scalar ones elsewhere. A decode step has few rows (8 at
// batch 1) of up to 2^18 elements, so one block a row would leave most SMs
// idle; split_layout() spreads a row over blocks where rows are few:
// - the max is free of order, so its pass spans the grid: slabs of a row
//   on separate blocks, their maxima met in a workspace (part) and taken
//   by the row's last block to arrive (an atomic ticket after
//   __threadfence, reset by that block);
// - the sum is not: common.row_sum fixes kChains = 256 chains a row, chain
//   t adding elements t, t + 256, ... onto +0 in sequence, then a halving
//   tree over the 256 partials. The chains are independent, so any
//   assignment of chains to blocks keeps the bits as long as each chain
//   adds in step order and the tree is the same: where rows are few and
//   long, a row's chains go to 4 ... 32 blocks (kC chains each, a strip of
//   columns of the row seen as (steps, 256)), staged through shared memory
//   with cp.async several stages deep so that many loads are in flight on
//   every SM; one warp adds each chain in step order, the chains' sums go
//   to the workspace at their chain's index (never by arrival), and the
//   row's last block runs rows::warp_tree_sum over them in the order's
//   lane layout. Elsewhere a row takes one block of 256 threads, thread t
//   running chain t (the exps over the whole grid with the chains summed
//   back from ex lost to this at every shape measured: PERF.md, row 7b);
// - the scale is elementwise: a block per 2048 elements of a row.
// The workspace is the wrapper's, one buffer per device and stream, so that
// no two launches that may run at once share one: the tickets are 0 before
// a launch and 0 after it, so it is zeroed only when it grows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

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

constexpr int kMaxDevices = 64;

// The current device's SM count, read from the runtime once a device.
cudaError_t sm_count(int* sms) {
  static std::atomic<int> cached[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices)
    return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  *sms = cached[dev].load(std::memory_order_relaxed);
  if (*sms > 0) return cudaSuccess;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) cached[dev].store(*sms, std::memory_order_relaxed);
  return err;
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
    int sms = 0;
    const cudaError_t err = sm_count(&sms);
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

// The split softmax's passes (softmax_split_*; the header says how each
// layout keeps the plain version's bits).

constexpr int kRowThreads = rows::kThreads;    // a pass's block: thread t = order's t
constexpr int kChains = rows::kThreads;        // the order's chains a row
constexpr int kScaleSpan = kRowThreads * 8;    // elements of a row one scale block covers
constexpr int kLoads = 4;                      // float4 loads a max-pass thread has in flight
constexpr int kSlabMin = kRowThreads * 4 * kLoads;   // fewest elements a max slab has
constexpr int kSlabAlign = kRowThreads * 4;    // a slab starts on a float4 of every thread
constexpr int kMaxBlocksPerSm = 4;             // max-pass blocks an SM where rows are few
constexpr int kTile = kRowThreads * 4;         // floats of a stage: one float4 a staging thread
constexpr int kStagers = kTile / 4;            // threads that stage (warps 0 ... kStagers / 32 - 1)
constexpr int kAhead = 6;                      // stages in flight
constexpr int kStages = kAhead + 2;            // and the one taking its exps, the one being added
constexpr int kMinSteps = 64;                  // fewest steps of a row spread over blocks
constexpr int kChainBlocks = 128;              // exp-pass blocks to aim for where rows are few

// One call's layout: the max pass's blocks a row (slabs) and the exp
// pass's (groups; 1 is one block a row). The rules below are the fastest
// layouts of tools/softmax_split_ab.py --split's sweep on the H100 (PERF.md
// §6, row 7b).
struct SplitLayout {
  int slabs;
  int groups;
};

// A row spreads over blocks only where the rows leave SMs idle and it has
// kMinSteps steps (kMinSteps * kChains elements), twice that where rows
// are many (m >= kChainBlocks / 2).
inline bool spread(long long m, int d, int sms) {
  const int steps = (d + kChains - 1) / kChains;
  return m < sms && steps >= (2 * m >= kChainBlocks ? 2 * kMinSteps : kMinSteps);
}

// Enough slabs for kMaxBlocksPerSm blocks on every SM, none shorter than
// kSlabMin elements, at most kChains a row (the workspace's partials).
inline int max_slabs(long long m, int d, int sms) {
  if (!spread(m, d, sms)) return 1;
  const long long fill = (kMaxBlocksPerSm * (long long)sms + m - 1) / m;
  const long long most = (d + kSlabMin - 1) / kSlabMin;
  return (int)std::min(std::min(fill, most), (long long)kChains);
}

// kC = 256 / groups chains a block: 64 where rows are many enough (m >=
// kChainBlocks / 2) to give every SM blocks; else the fewest of 8, 16, 32
// blocks a row that give kChainBlocks blocks (about one an SM), as a block
// of 64 chains adds two a lane.
inline int chain_groups(long long m, int d, int sms) {
  if (!spread(m, d, sms)) return 1;
  if (2 * m >= kChainBlocks) return 4;
  int g = 8;
  while (g < 32 && m * g < kChainBlocks) g *= 2;
  return g;
}

inline SplitLayout split_layout(long long m, int d, int sms) {
  return SplitLayout{max_slabs(m, d, sms), chain_groups(m, d, sms)};
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of kBytes (16 or 4) from src to dst; with `in` false nothing is
// read and dst gets zeros.
template <int kBytes>
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool in) {
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(in ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(in ? 4 : 0) : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The row's ticket, taken by one thread once its block's partials of the
// row are written and fenced: true where the block is the last of `blocks`
// to arrive. That block sees every partial (each block fences before its
// ticket, the last one after it) and resets the ticket for the next launch.
__device__ __forceinline__ bool last_to_arrive(unsigned int* ticket, unsigned int blocks) {
  const bool last = atomicAdd(ticket, 1u) == blocks - 1;
  if (last) {
    __threadfence();
    *ticket = 0;
  }
  return last;
}

// One warp, every lane, after its lanes wrote their chains' sums of `row`
// to part (kChains a row, at the chain's index): the row's ticket; in the
// row's last block the order's halving tree over the kChains sums, lane l
// holding chains kPerLane*l ... kPerLane*l + kPerLane - 1 as
// rows::warp_tree_sum wants, into sum[row].
__device__ __forceinline__ void finish_sum(const float* part, unsigned int* ticket, float* sum,
                                           int row, unsigned int blocks) {
  const int lane = threadIdx.x & 31;
  __threadfence();
  __syncwarp();
  bool last = false;
  if (lane == 0) last = last_to_arrive(ticket + row, blocks);
  if (!__shfl_sync(0xFFFFFFFFu, last, 0)) return;
  __threadfence();
  float p[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) p[j] = __ldcg(part + (long long)row * kChains + kPer * lane + j);
  const float s = rows::warp_tree_sum(p);
  if (lane == 0) sum[row] = s;
}

// The rows' maxima: block b takes slab b % slabs (span elements, float4
// loads where kVec) of row b / slabs. With several slabs their maxima meet
// in part and the row's last block takes the max of them.
template <bool kVec>
__global__ void __launch_bounds__(kRowThreads)
    split_max_kernel(const float* __restrict__ x, float* __restrict__ mx, float* __restrict__ part,
                     unsigned int* __restrict__ ticket, int d, int slabs, int span) {
  __shared__ float red_sh[kRowThreads / 32];
  const int row = blockIdx.x / slabs, slab = blockIdx.x % slabs;
  const float* xr = x + (long long)row * d;
  const int lo = slab * span, hi = min(d, lo + span);
  float m = -INFINITY;
  // A thread's kLoads loads are issued before the first of them is used,
  // and only the loaded ones are compared.
  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int i = lo / 4 + threadIdx.x; i < hi / 4; i += kLoads * kRowThreads) {
      float4 v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        if (i + u * kRowThreads < hi / 4) v[u] = x4[i + u * kRowThreads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        if (i + u * kRowThreads < hi / 4)
          m = rows::nan_max(m, rows::nan_max(rows::nan_max(v[u].x, v[u].y),
                                             rows::nan_max(v[u].z, v[u].w)));
    }
  } else {
    for (int i = lo + threadIdx.x; i < hi; i += 4 * kLoads * kRowThreads) {
      float v[4 * kLoads];
#pragma unroll
      for (int u = 0; u < 4 * kLoads; ++u)
        if (i + u * kRowThreads < hi) v[u] = xr[i + u * kRowThreads];
#pragma unroll
      for (int u = 0; u < 4 * kLoads; ++u)
        if (i + u * kRowThreads < hi) m = rows::nan_max(m, v[u]);
    }
  }
  m = rows::warp_max(m);
  if ((threadIdx.x & 31) == 0) red_sh[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x >= 32) return;
  m = rows::warp_max(threadIdx.x < kRowThreads / 32 ? red_sh[threadIdx.x] : -INFINITY);
  if (slabs == 1) {
    if (threadIdx.x == 0) mx[row] = m;
    return;
  }
  bool last = false;
  if (threadIdx.x == 0) {
    part[(long long)row * kChains + slab] = m;
    __threadfence();
    last = last_to_arrive(ticket + row, slabs);
  }
  if (!__shfl_sync(0xFFFFFFFFu, last, 0)) return;
  __threadfence();
  m = -INFINITY;
  for (int i = threadIdx.x; i < slabs; i += 32)
    m = rows::nan_max(m, __ldcg(part + (long long)row * kChains + i));
  m = rows::warp_max(m);
  if (threadIdx.x == 0) mx[row] = m;
}

// exp(x - mfin) and its row sums, one block a row: thread t runs chain t.
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

// exp(x - mfin) and its row sums, the row's chains over `groups` blocks:
// block b takes chains [kC * (b % groups), + kC) of row b / groups, the
// columns of the row seen as (steps, kChains). kStagers threads stage them kTile
// floats (kSteps steps) at a time with cp.async, kAhead stages ahead in a
// ring of kStages; each thread takes the exps of its own four floats,
// writes them to ex and leaves them in the stage. The last warp adds each chain's
// column of a stage in step order, one stage behind. Elements past the
// row's end are staged as +0, which leaves a chain's sum as it is (the
// order's padding).
template <int kC, bool kVec>
__global__ void __launch_bounds__(kStagers + 32)
    split_exp_chains_kernel(const float* __restrict__ x, const float* __restrict__ top,
                            float* __restrict__ ex, float* __restrict__ sum,
                            float* __restrict__ part, unsigned int* __restrict__ ticket, int d,
                            int groups) {
  constexpr int kSteps = kTile / kC;                 // steps of the block's chains a stage holds
  constexpr int kLane = kC > 32 ? kC / 32 : 1;       // chains a lane of the adding warp adds
  constexpr int kBatch = 16;                         // steps a lane reads ahead (kSteps >= 16)
  __shared__ __align__(16) float stage_sh[kStages][kTile];
  const int row = blockIdx.x / groups;
  const int col = (blockIdx.x % groups) * kC;
  const long long off = (long long)row * d;
  const float t = top[row];
  const float mfin = isfinite(t) ? t : 0.0f;
  const int tiles = ((d + kChains - 1) / kChains + kSteps - 1) / kSteps;
  const int tid = threadIdx.x, lane = tid & 31;
  const int e = 4 * tid;                                         // a staging thread's floats
  const int first = (e / kC) * kChains + col + e % kC;          // their row index in stage 0
  auto index = [&](int tile) { return first + tile * (kSteps * kChains); };
  auto fetch = [&](int tile) {
    if (tile < tiles) {
      const int i = index(tile);
      float* dst = &stage_sh[tile % kStages][e];
      if (kVec) {
        copy_async<16>(dst, x + off + (i < d ? i : 0), i < d);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          copy_async<4>(dst + j, x + off + (i + j < d ? i + j : 0), i + j < d);
      }
    }
    copy_commit();   // past the last stage an empty group keeps the count
  };
  float acc[kLane];
#pragma unroll
  for (int q = 0; q < kLane; ++q) acc[q] = 0.0f;
  if (tid < kStagers)
    for (int s = 0; s < kAhead; ++s) fetch(s);
  for (int tile = 0; tile <= tiles; ++tile) {
    if (tid < kStagers) {
      if (tile < tiles) {
        fetch(tile + kAhead);
        copy_wait<kAhead>();   // this thread's copies of stage `tile` have landed
        float* p = &stage_sh[tile % kStages][e];
        const int i = index(tile);
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = (kVec ? i : i + j) < d ? expf(__fsub_rn(p[j], mfin)) : 0.0f;
        if (kVec) {
          const float4 w = make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(p) = w;
          if (i < d) *reinterpret_cast<float4*>(ex + off + i) = w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            p[j] = v[j];
            if (i + j < d) ex[off + i + j] = v[j];
          }
        }
      }
    } else if (tile > 0 && (kC >= 32 || lane < kC)) {
      const float* p = stage_sh[(tile - 1) % kStages];
      // kBatch steps read before they are added: the chain's adds wait on
      // no shared-memory load but the first.
      for (int r0 = 0; r0 < kSteps; r0 += kBatch) {
        float v[kBatch][kLane];
#pragma unroll
        for (int r = 0; r < kBatch; ++r) {
#pragma unroll
          for (int q = 0; q < kLane; ++q) v[r][q] = p[(r0 + r) * kC + lane + 32 * q];
        }
#pragma unroll
        for (int r = 0; r < kBatch; ++r) {
#pragma unroll
          for (int q = 0; q < kLane; ++q) acc[q] = __fadd_rn(acc[q], v[r][q]);
        }
      }
    }
    // Stage `tile` is exp'd and stage `tile - 1` added before either is reused.
    __syncthreads();
  }
  if (tid < kStagers) return;
  if (kC >= 32 || lane < kC) {
#pragma unroll
    for (int q = 0; q < kLane; ++q) part[(long long)row * kChains + col + lane + 32 * q] = acc[q];
  }
  finish_sum(part, ticket, sum, row, groups);
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

bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
}

// The current device's layout of (m, d) rows.
cudaError_t layout_of(long long m, int d, SplitLayout* lay) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err == cudaSuccess) *lay = split_layout(m, d, sms);
  return err;
}

template <int kC>
void launch_chains(bool vec, long long m, int d, const float* x, const float* top, float* ex,
                   float* sum, float* part, unsigned int* ticket, cudaStream_t stream) {
  constexpr int kGroups = kChains / kC;
  const unsigned int blocks = (unsigned int)(m * kGroups);
  if (vec)
    split_exp_chains_kernel<kC, true><<<blocks, kStagers + 32, 0, stream>>>(
        x, top, ex, sum, part, ticket, d, kGroups);
  else
    split_exp_chains_kernel<kC, false><<<blocks, kStagers + 32, 0, stream>>>(
        x, top, ex, sum, part, ticket, d, kGroups);
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
// (0 where total is 0), total (m) the sums over the ranks. part (m,
// kChains) f32 and ticket (m) u32 are the workspace of a row spread over
// blocks: the tickets are 0 at the call and left 0.
int softmax_split_max(const void* x, void* mx, void* part, void* ticket, long long m, int d,
                      cudaStream_t stream) {
  SplitLayout lay;
  cudaError_t err = layout_of(m, d, &lay);
  if (err != cudaSuccess) return (int)err;
  const int span = ((d + lay.slabs - 1) / lay.slabs + kSlabAlign - 1) / kSlabAlign * kSlabAlign;
  const int slabs = (d + span - 1) / span;
  if (m * slabs > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const unsigned int blocks = (unsigned int)(m * slabs);
  const float* xf = static_cast<const float*>(x);
  float* pf = static_cast<float*>(part);
  unsigned int* tk = static_cast<unsigned int*>(ticket);
  if (d % 4 == 0 && aligned16(x, x))
    split_max_kernel<true><<<blocks, kRowThreads, 0, stream>>>(
        xf, static_cast<float*>(mx), pf, tk, d, slabs, span);
  else
    split_max_kernel<false><<<blocks, kRowThreads, 0, stream>>>(
        xf, static_cast<float*>(mx), pf, tk, d, slabs, span);
  return (int)cudaGetLastError();
}

int softmax_split_exp(const void* x, const void* top, void* ex, void* sum, void* part,
                      void* ticket, long long m, int d, cudaStream_t stream) {
  SplitLayout lay;
  cudaError_t err = layout_of(m, d, &lay);
  if (err != cudaSuccess) return (int)err;
  const float* xf = static_cast<const float*>(x);
  const float* tf = static_cast<const float*>(top);
  float* ef = static_cast<float*>(ex);
  float* sf = static_cast<float*>(sum);
  float* pf = static_cast<float*>(part);
  unsigned int* tk = static_cast<unsigned int*>(ticket);
  const bool vec = d % 4 == 0 && aligned16(x, ex);
  const int groups = lay.groups;
  if (m * groups > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (groups == 4) {
    launch_chains<kChains / 4>(vec, m, d, xf, tf, ef, sf, pf, tk, stream);
  } else if (groups == 8) {
    launch_chains<kChains / 8>(vec, m, d, xf, tf, ef, sf, pf, tk, stream);
  } else if (groups == 16) {
    launch_chains<kChains / 16>(vec, m, d, xf, tf, ef, sf, pf, tk, stream);
  } else if (groups == 32) {
    launch_chains<kChains / 32>(vec, m, d, xf, tf, ef, sf, pf, tk, stream);
  } else if (groups == 1) {
    split_exp_kernel<<<(unsigned int)m, kRowThreads, 0, stream>>>(xf, tf, ef, sf, d);
  } else {
    return (int)cudaErrorInvalidValue;
  }
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
