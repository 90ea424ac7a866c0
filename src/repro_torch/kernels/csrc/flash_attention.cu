// Hopper kernel of flash attention on f32 q/k/v with the division unit's 1/l,
// with a plain C interface for ctypes (built by kernels/_build.py with nvcc
// -fmad=false for sm_90a). bf16 q/k/v take the tensor cores instead
// (csrc/flash_attention_tc.cu): a bf16 tensor core cannot hold f32 q/k.
//
// Replaces the f32 route of the reference's Pallas TPU kernel
// src/repro/kernels/flash_attention.py flash_attention / _flash_kernel:
// online-softmax attention over (BH, S, hd) with the running max m, sum l and
// output acc updated once per key block, masked scores at NEG_INF = -1e30
// (causal and keys at or past sk_real), early skip of key blocks above the
// diagonal, and the final acc * recip_f32_bits(l).
//
// Bound: operations. Causal attention at S = 2048, hd = 64 does ~2*S^2*hd/2
// multiply-adds for QK^T and as many for PV per head, against 4 reads and
// writes of (S, hd) per head: ~250 f32 operations per byte, far above the
// card's ~20 f32 operations per byte of HBM bandwidth outside the tensor
// cores.
//
// Design: simple and right first. One block of kRows threads per (head,
// tile of kRows query rows), one thread per query row: its q row (in
// registers up to hd = 64, in shared memory above), its acc[hd] in
// registers, its m and l. A loop over key blocks takes the place of the TPU
// grid's sequential key axis; each key block is staged through shared
// memory kChunk keys at a time (K for the scores, then V), widened to f32,
// read by every thread as a broadcast. The block's scores stay in shared
// memory between the two passes. Every rounding is explicit (-fmad=false,
// __fmaf_rn only where written) and in the order the plain version
// (kernels/flash_attention.py) repeats: the dot over hd in order, the block
// max, l and acc rescaled by corr, then key by key l += p and acc += p*v.
// No tensor cores, no TMA: a fast kernel is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "rows.cuh"
#include "tsdiv_body.cuh"

namespace {

constexpr int kRows = 64;        // query rows per block, one per thread
constexpr int kChunk = 32;       // keys staged in shared memory at a time
constexpr int kMaxBlockK = 128;  // MAX_BLOCK_K in kernels/flash_attention.py
constexpr float kNegInf = -1e30f;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kMaxBlockK * kRows + kChunk * HD + (HD > 64 ? HD * kRows : 0));
}

template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int n) {
  for (int i = threadIdx.x; i < n; i += kRows) dst[i] = rows::to_f(src[i]);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kRows)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int sq, int sk, int sk_real, int block_k, int n_qt,
                 int causal, int skip, float scale, const __grid_constant__ TsdivSeedTable table, int n_iters,
                 int schedule) {
  constexpr bool kQInRegs = HD <= 64;
  extern __shared__ float sh[];
  float* s_sh = sh;                           // [block_k][kRows]: this block's scores
  float* kv_sh = sh + kMaxBlockK * kRows;     // [kChunk][HD]: staged keys or values
  float* q_sh = kv_sh + kChunk * HD;          // [HD][kRows] when q is not in registers

  const int t = threadIdx.x;
  const long long bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kRows;
  const int row = q0 + t;
  const bool valid = row < sq;
  const T* kh = k + bh * sk * HD;
  const T* vh = v + bh * sk * HD;

  float qr[kQInRegs ? HD : 1];
  {
    const T* qrow = q + (bh * sq + (valid ? row : 0)) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      const float x = rows::to_f(qrow[d]);
      if constexpr (kQInRegs) qr[d] = x; else q_sh[d * kRows + t] = x;
    }
  }
  auto qv = [&](int d) -> float {
    if constexpr (kQInRegs) return qr[d]; else return q_sh[d * kRows + t];
  };
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.0f;
  float m = kNegInf, l = 0.0f;

  // The last key block any row of this tile needs (all, without the skip).
  int last = sk / block_k - 1;
  if (causal && skip) last = min(last, (min(q0 + kRows, sq) - 1) / block_k);
  for (int kb = 0; kb <= last; ++kb) {
    const int k0 = kb * block_k;
    const bool run = valid && !(causal && skip && k0 > row);
    // Pass 1: the block's scores and their max.
    float mcur = -INFINITY;
    auto keep = [&](int j, float s) {
      s = __fmul_rn(s, scale);
      const int kpos = k0 + j;
      if ((causal && kpos > row) || kpos >= sk_real) s = kNegInf;
      s_sh[j * kRows + t] = s;
      mcur = rows::nan_max(mcur, s);
    };
    for (int c = 0; c < block_k; c += kChunk) {
      const int nc = min(kChunk, block_k - c);
      __syncthreads();
      stage(kv_sh, kh + (long long)(k0 + c) * HD, nc * HD);
      __syncthreads();
      if (!run) continue;
      int j = 0;
      for (; j + 4 <= nc; j += 4) {     // four independent dot chains
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          const float x = qv(d);
          s0 = __fmaf_rn(x, kv_sh[j * HD + d], s0);
          s1 = __fmaf_rn(x, kv_sh[(j + 1) * HD + d], s1);
          s2 = __fmaf_rn(x, kv_sh[(j + 2) * HD + d], s2);
          s3 = __fmaf_rn(x, kv_sh[(j + 3) * HD + d], s3);
        }
        keep(c + j, s0);
        keep(c + j + 1, s1);
        keep(c + j + 2, s2);
        keep(c + j + 3, s3);
      }
      for (; j < nc; ++j) {
        float s = 0.0f;
#pragma unroll
        for (int d = 0; d < HD; ++d) s = __fmaf_rn(qv(d), kv_sh[j * HD + d], s);
        keep(c + j, s);
      }
    }
    // Pass 2: rescale by corr, then key by key l += p and acc += p * v.
    float mnew = m;
    if (run) {
      mnew = rows::nan_max(m, mcur);
      const float corr = expf(__fsub_rn(m, mnew));
      l = __fmul_rn(l, corr);
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = __fmul_rn(acc[d], corr);
    }
    for (int c = 0; c < block_k; c += kChunk) {
      const int nc = min(kChunk, block_k - c);
      __syncthreads();
      stage(kv_sh, vh + (long long)(k0 + c) * HD, nc * HD);
      __syncthreads();
      if (!run) continue;
      for (int j = 0; j < nc; ++j) {
        const float p = expf(__fsub_rn(s_sh[(c + j) * kRows + t], mnew));
        l = __fadd_rn(l, p);
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] = __fmaf_rn(p, kv_sh[j * HD + d], acc[d]);
      }
    }
    m = mnew;
  }
  if (!valid) return;
  const float rl = tsdiv::recip_f32_bits(l, table, n_iters, schedule);
  T* orow = out + (bh * sq + row) * HD;
#pragma unroll
  for (int d = 0; d < HD; ++d) rows::store(orow + d, __fmul_rn(acc[d], rl));
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, long long bh, int sq, int sk,
           int sk_real, int block_k, int causal, int skip, float scale, TsdivSeedTable table,
           int n_iters, int schedule, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (sq + kRows - 1) / kRows;
  flash_kernel<T, HD><<<(unsigned int)(bh * n_qt), kRows, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, sk, sk_real, block_k, n_qt, causal, skip, scale, table, n_iters,
      schedule);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* out, long long bh,
             int sq, int sk, int sk_real, int block_k, int causal, int skip, float scale,
             TsdivSeedTable table, int n_iters, int schedule, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, bh, sq, sk, sk_real, block_k, causal, skip, scale, table, n_iters, schedule, stream);
    case 32: return launch<T, 32>(q, k, v, out, bh, sq, sk, sk_real, block_k, causal, skip, scale, table, n_iters, schedule, stream);
    case 64: return launch<T, 64>(q, k, v, out, bh, sq, sk, sk_real, block_k, causal, skip, scale, table, n_iters, schedule, stream);
    case 128: return launch<T, 128>(q, k, v, out, bh, sq, sk, sk_real, block_k, causal, skip, scale, table, n_iters, schedule, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: (bh, sq, hd), k/v: (bh, sk, hd), out: (bh, sq, hd), contiguous f32; sk
// a multiple of block_k <= kMaxBlockK; hd in {16, 32, 64, 128}. Returns the
// launch's cudaGetLastError() (cudaErrorInvalidValue for an hd or block_k
// the kernel lacks). bf16 q/k/v go to csrc/flash_attention_tc.cu.
int flash_attention_f32(const void* q, const void* k, const void* v, void* out, long long bh,
                        int sq, int sk, int sk_real, int hd, int block_k, int causal, int skip,
                        float scale, TsdivSeedTable table, int n_iters, int schedule,
                        cudaStream_t stream) {
  if (block_k < 1 || block_k > kMaxBlockK || sk % block_k != 0) return (int)cudaErrorInvalidValue;
  return dispatch<float>(hd, q, k, v, out, bh, sq, sk, sk_real, block_k, causal, skip, scale,
                         table, n_iters, schedule, stream);
}

}  // extern "C"
