// Row reductions of the consumer kernels (softmax, RMSNorm) in one fixed
// order, so that a kernel and its plain PyTorch version (kernels/common.py
// row_sum) give the same bits. The order is that of kThreads threads over a
// row: thread t adds lanes t, t + kThreads, ... in sequence onto +0; then a
// halving tree adds partial t + h onto partial t for h = kThreads/2, ..., 1.
//
// Both kernels run it on one warp per row: lane l holds elements
// c*kThreads + kPerLane*l ... c*kThreads + kPerLane*l + kPerLane - 1 of each
// kThreads-element chunk c (a Group), so its slot j adds thread
// kPerLane*l + j's lanes, and warp_tree_sum finishes with the tree's
// additions. No shared memory, no barrier.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace rows {

constexpr int kThreads = 256;   // REDUCE_THREADS in kernels/common.py
constexpr int kPerLane = kThreads / 32;

// The halving tree over one warp's kPerLane partials a lane (lane l, slot j
// holding thread kPerLane*l + j's): h = kThreads/2 ... kPerLane pair
// threads in different lanes, the same slot, kPerLane*l + j with
// kPerLane*(l + h/kPerLane) + j, so they are shuffles down by h/kPerLane
// lanes (16, 8, 4, 2, 1); h = kPerLane/2 ... 1 pair slots inside the lane.
// The tree's additions in its order; lane 0 gets the sum (the other lanes
// hold parts of the tree).
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

// The warp's max of v (order-free but for which nan or signed zero it
// returns, which no caller's result depends on); every lane gets it.
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int lanes = 16; lanes > 0; lanes >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xFFFFFFFFu, v, lanes));
  return v;
}

// A lane's kPerLane elements of one chunk of a row, as stored: f32 as
// floats, bf16 as packed pairs. load() reads the n of them inside the row
// and sets the slots past its end to `fill` (0 leaves a sum's partials
// unchanged, -inf a max); put() and store() write them. kVec is one or two
// 16-byte accesses (n is then >= kPerLane or <= 0).
template <typename T>
struct Group;

template <>
struct Group<float> {
  float v[kPerLane];
  template <bool kVec>
  __device__ __forceinline__ void load(const float* p, int n, float fill) {
    if (kVec) {
      const float4 z = make_float4(fill, fill, fill, fill);
      const float4 a = n > 0 ? reinterpret_cast<const float4*>(p)[0] : z;
      const float4 b = n > 0 ? reinterpret_cast<const float4*>(p)[1] : z;
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
      v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) v[j] = j < n ? p[j] : fill;
    }
  }
  __device__ __forceinline__ float get(int j) const { return v[j]; }
  __device__ __forceinline__ void put(const float (&f)[kPerLane]) {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) v[j] = f[j];
  }
  template <bool kVec>
  __device__ __forceinline__ void store(float* p, int n) const {
    if (kVec) {
      reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int j = 0; j < kPerLane; ++j)
        if (j < n) p[j] = v[j];
    }
  }
};

template <>
struct Group<__nv_bfloat16> {
  uint32_t u[kPerLane / 2];   // element 2i in the low half of u[i], 2i + 1 in the high
  template <bool kVec>
  __device__ __forceinline__ void load(const __nv_bfloat16* p, int n, float fill) {
    const uint32_t f = __bfloat16_as_ushort(__float2bfloat16_rn(fill));
    if (kVec) {
      const uint32_t ff = f | f << 16;
      const uint4 q = n > 0 ? *reinterpret_cast<const uint4*>(p) : make_uint4(ff, ff, ff, ff);
      u[0] = q.x, u[1] = q.y, u[2] = q.z, u[3] = q.w;
    } else {
      const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
      for (int i = 0; i < kPerLane / 2; ++i)
        u[i] = (2 * i < n ? (uint32_t)h[2 * i] : f) |
               (2 * i + 1 < n ? (uint32_t)h[2 * i + 1] : f) << 16;
    }
  }
  // bf16 -> f32 is the bits shifted up: exact, nan payloads included.
  __device__ __forceinline__ float get(int j) const {
    return __uint_as_float(j & 1 ? u[j / 2] & 0xFFFF0000u : u[j / 2] << 16);
  }
  __device__ __forceinline__ void put(const float (&f)[kPerLane]) {
#pragma unroll
    for (int i = 0; i < kPerLane / 2; ++i)
      u[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i])) |
             (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1])) << 16;
  }
  template <bool kVec>
  __device__ __forceinline__ void store(__nv_bfloat16* p, int n) const {
    if (kVec) {
      *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
    } else {
      unsigned short* h = reinterpret_cast<unsigned short*>(p);
#pragma unroll
      for (int j = 0; j < kPerLane; ++j)
        if (j < n) h[j] = (unsigned short)(j & 1 ? u[j / 2] >> 16 : u[j / 2] & 0xFFFFu);
    }
  }
};

}  // namespace rows
