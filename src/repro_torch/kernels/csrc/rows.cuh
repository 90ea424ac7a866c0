// Row reductions of the consumer kernels (softmax, RMSNorm) in one fixed
// order, so that a kernel and its plain PyTorch version (kernels/common.py
// row_sum) give the same bits: one block of kThreads threads per row; thread
// t adds lanes t, t + kThreads, ... in sequence onto +0; then a halving tree
// adds partial t + h onto partial t for h = kThreads/2, ..., 1.
#pragma once

#include <cuda_bf16.h>
#include <math.h>

namespace rows {

constexpr int kThreads = 256;   // REDUCE_THREADS in kernels/common.py
constexpr int kPerLane = kThreads / 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The halving tree over the block's partial sums; every thread gets the sum.
__device__ __forceinline__ float tree_sum(float v, float* sh) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
#pragma unroll
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (t < h) sh[t] = __fadd_rn(sh[t], sh[t + h]);
    __syncthreads();
  }
  const float s = sh[0];
  __syncthreads();
  return s;
}

// The halving tree over one warp's kPerLane partials a lane (lane l, slot j
// holding thread kPerLane*l + j's): h = kThreads/2 ... kPerLane pair
// threads in different lanes, the same slot, kPerLane*l + j with
// kPerLane*(l + h/kPerLane) + j, so they are shuffles down by h/kPerLane
// lanes (16, 8, 4, 2, 1); h = kPerLane/2 ... 1 pair slots inside the lane.
// The same additions in the same order as tree_sum; lane 0 gets the sum
// (the other lanes hold parts of the tree). No shared memory, no barrier.
__device__ __forceinline__ float warp_tree_sum(float (&p)[kPerLane]) {
#pragma unroll
  for (int lanes = 16; lanes > 0; lanes >>= 1) {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      p[j] = __fadd_rn(p[j], __shfl_down_sync(0xFFFFFFFFu, p[j], lanes));
  }
#pragma unroll
  for (int h = kPerLane / 2; h > 0; h >>= 1) {
#pragma unroll
    for (int j = 0; j < h; ++j) p[j] = __fadd_rn(p[j], p[j + h]);
  }
  return p[0];
}

// max that propagates nan, as a reduction's max does.
__device__ __forceinline__ float nan_max(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return a > b ? a : b;
}

// The block's row max (order-free but for signed zeros, which no caller's
// result depends on); every thread gets it.
__device__ __forceinline__ float tree_max(float v, float* sh) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
#pragma unroll
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (t < h) sh[t] = nan_max(sh[t], sh[t + h]);
    __syncthreads();
  }
  const float m = sh[0];
  __syncthreads();
  return m;
}

}  // namespace rows
