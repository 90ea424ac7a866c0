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
// Bound: f32 operations. Causal attention at S = 2048, hd = 64 does
// ~S^2*hd/2 multiply-adds for QK^T and as many for PV per head against 4
// reads and writes of (S, hd): ~250 f32 operations per byte, far above the
// card's ~20 f32 operations per byte of HBM bandwidth outside the tensor
// cores. It stays off the tensor cores: TF32 keeps 10 mantissa bits, and
// every product here must be the f32 fma of the plain version.
//
// Design: a register-tiled SIMT kernel, as a CUDA-core SGEMM is built. One
// block of 4 warps per (head, tile of kRows = 64 query rows), the tiles
// with the most key blocks first. Q stays in shared memory for the whole
// key loop; each key block (block_k <= 128 keys) is staged with cp.async,
// rows padded by 4 floats so that the reads below meet no bank conflict.
//   * QK^T: each thread owns 8 rows (rg + 8i) x 8 keys (kg + 16j) of the
//     64 x 128 score tile and reads q and k as float4 along d: 16 shared
//     loads per 256 fma. Every slot of the tile is multiplied, masked or
//     not, past block_k too: the masks set their scores (a guard around
//     wholly masked slices was slower on the H100, tools/flash_fold_ab.py).
//   * The block max: per thread, then across the 16 threads of a row by
//     xor shuffles (the max is exact in any order); corr = expf(m - m_new)
//     and p = expf(s - m_new) with libdevice expf. p goes to shared memory,
//     [key][row], 64 keys at a time.
//   * PV: each thread owns 8 rows x hd/16 dims of acc and reads p and v as
//     float4 (3 shared loads per 32 fma at hd = 64); acc = acc*corr, then
//     key by key acc = fma(p, v, acc). The 8 threads that own the first
//     dims also keep l: l = l*corr, then key by key l += p.
//   * V of a block is copied while its scores are computed, K of the next
//     block while its PV runs.
// Every rounding is explicit (-fmad=false, __fmaf_rn only where written) and
// in the order the plain version (kernels/flash_attention.py) repeats per
// query row and key block: the dot over hd in order from +0, * scale, the
// masks, the block max, l and acc rescaled by corr, then key by key l += p
// and acc += p*v. Which thread does which of them changes no bit. A row
// whose key block lies wholly above its diagonal skips it (the per-row
// `run` predicate). Shared memory per block: 100.5 KB at hd = 64, which
// holds 2 blocks (8 warps) per SM, as the registers (~254 a thread) do.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tsdiv_body.cuh"

namespace {

constexpr int kRows = 64;        // query rows per block
constexpr int kThreads = 128;
constexpr int kMaxBlockK = 128;  // MAX_BLOCK_K in kernels/flash_attention.py
constexpr int kHalfK = kMaxBlockK / 2;   // keys of p in shared memory at once
constexpr int kLdP = kRows + 4;  // p's row stride (floats)
constexpr int kMinBlocks = 2;
constexpr float kNegInf = -1e30f;

template <int HD>
struct Layout {
  static constexpr int kLd = HD + 4;   // q and K row stride (floats)
  static constexpr int kTd = HD / 16;  // acc dims per thread
  static constexpr int kQ = kRows * kLd;
  static constexpr int kK = kMaxBlockK * kLd;
  static constexpr int kP = kHalfK * kLdP;
  static constexpr int kV = kMaxBlockK * HD;
  static constexpr size_t kBytes = sizeof(float) * (kQ + kK + kP + kV + 2 * kRows);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// Rows [0, n) of an (n, HD) block at src into dst, row stride ld floats;
// 16-byte copies when the tensors are 16-byte aligned (vec), else 4-byte.
template <int HD>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src, int n, bool vec) {
  if (vec) {
    constexpr int kChunks = HD / 4;                 // 16-byte chunks a row
    constexpr int kRowsPerPass = kThreads / kChunks;
    const int c = (threadIdx.x % kChunks) * 4;
    for (int r = threadIdx.x / kChunks; r < n; r += kRowsPerPass)
      cp_async16(dst + r * ld + c, src + r * HD + c);
  } else {
    for (int i = threadIdx.x; i < n * HD; i += kThreads)
      cp_async4(dst + (i / HD) * ld + i % HD, src + i);
  }
}

// N consecutive floats of shared memory (N a power of two, 16-byte aligned
// from N = 4 on) into registers.
template <int N>
__device__ __forceinline__ void load_sh(float (&r)[N], const float* p) {
  if constexpr (N >= 4) {
#pragma unroll
    for (int c = 0; c < N; c += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + c);
      r[c] = x.x;
      r[c + 1] = x.y;
      r[c + 2] = x.z;
      r[c + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    r[0] = x.x;
    r[1] = x.y;
  } else {
    r[0] = p[0];
  }
}

// max that propagates nan (max.NaN, one instruction). Which nan, and which
// zero of max(-0, +0), no result depends on: a nan score makes its row all
// nan either way, and m enters only as exp(x - m).
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The 8 x 8 scores of one thread from +0, the dot over d in order: rows
// rg + 8i against keys kg + 16j, q and k as float4 along d.
template <int HD>
__device__ __forceinline__ void qk(float (&s)[8][8], const float* q_sh, const float* k_sh, int rg,
                                   int kg) {
  constexpr int kLd = HD + 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float qv[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) load_sh<4>(qv[i], q_sh + (rg + 8 * i) * kLd + d);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float kv[4];
      load_sh<4>(kv, k_sh + (kg + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s[i][j] = __fmaf_rn(qv[i][0], kv[0], s[i][j]);
        s[i][j] = __fmaf_rn(qv[i][1], kv[1], s[i][j]);
        s[i][j] = __fmaf_rn(qv[i][2], kv[2], s[i][j]);
        s[i][j] = __fmaf_rn(qv[i][3], kv[3], s[i][j]);
      }
    }
  }
}

// s = s * scale, then (kMasked) the masks: NEG_INF for keys past a row's
// diagonal or at or past sk_real, -inf (out of the max) for slots past
// block_k, which are not keys of the block; mx = each row's max over the
// block, across the row's 16 threads.
template <bool kMasked>
__device__ __forceinline__ void scale_and_max(float (&s)[8][8], float (&mx)[8], float scale,
                                              int row0, int kpos0, int kg, int block_k,
                                              int sk_real, int causal) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mx[i] = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float x = __fmul_rn(s[i][j], scale);
      if constexpr (kMasked) {
        const int kpos = kpos0 + 16 * j;
        if ((causal && kpos > row0 + 8 * i) || kpos >= sk_real) x = kNegInf;
        if (kg + 16 * j >= block_k) x = -INFINITY;
      }
      s[i][j] = x;
      mx[i] = max_nan(mx[i], x);
    }
#pragma unroll
    for (int o = 1; o < 16; o *= 2) mx[i] = max_nan(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], o));
  }
}

// p of keys [H kHalfK, (H + 1) kHalfK) (slices j = 4H .. 4H + 3) to
// p_sh[key - H kHalfK][row].
template <int H>
__device__ __forceinline__ void store_p(const float (&s)[8][8], float* p_sh, int rg, int kg,
                                        int block_k) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 4 * H; j < 4 * H + 4; ++j) {
      const int c = kg + 16 * j;
      if (c < block_k) p_sh[(c - kHalfK * H) * kLdP + rg + 8 * i] = s[i][j];
    }
}

// PV over n keys (p and v rows 0 .. n-1): acc = fma(p, v, acc) and, where
// own_l, l += p, key by key, on the rows that run (every row when kAll).
template <int HD, bool kAll>
__device__ __forceinline__ void pv(float (&acc)[8][HD / 16], float (&l)[8], const bool (&run)[8],
                                   const float* p_sh, const float* v_sh, int pr, int d0, int n,
                                   bool own_l) {
  constexpr int kTd = HD / 16;
#pragma unroll 8
  for (int j = 0; j < n; ++j) {
    const float4 pa = *reinterpret_cast<const float4*>(p_sh + j * kLdP + 4 * pr);
    const float4 pb = *reinterpret_cast<const float4*>(p_sh + j * kLdP + 32 + 4 * pr);
    const float p[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
    float v[kTd];
    load_sh<kTd>(v, v_sh + j * HD + d0);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (kAll || run[e]) {
#pragma unroll
        for (int t = 0; t < kTd; ++t) acc[e][t] = __fmaf_rn(p[e], v[t], acc[e][t]);
        if (own_l) l[e] = __fadd_rn(l[e], p[e]);
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int sq, int sk,
                 int sk_real, int block_k, int n_qt, int causal, int skip, float scale,
                 const __grid_constant__ TsdivSeedTable table, int n_iters, int schedule,
                 int vec) {
  using L = Layout<HD>;
  constexpr int kLd = L::kLd, kTd = L::kTd;
  extern __shared__ __align__(16) float sh[];
  float* q_sh = sh;                  // [kRows][kLd]
  float* k_sh = q_sh + L::kQ;        // [kMaxBlockK][kLd]
  float* p_sh = k_sh + L::kK;        // [kHalfK][kLdP]: half of the block's p
  float* v_sh = p_sh + L::kP;        // [kMaxBlockK][HD]
  float* row_sh = v_sh + L::kV;      // [kRows]: corr per row, then 1/l
  float* l_sh = row_sh + kRows;      // [kRows]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // Heads vary fastest and the query tiles run from the last (the most key
  // blocks under the causal mask) to the first.
  const long long n_bh = gridDim.x / n_qt;
  const long long bh = blockIdx.x % n_bh;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / n_bh)) * kRows;
  // QK^T: rows rg + 8i, keys kg + 16j; the 16 threads of a row group share
  // a warp. PV: rows 4pr + e and 32 + 4pr + e, dims d0 .. d0 + kTd - 1.
  const int kg = lane % 16, rg = 2 * warp + lane / 16;
  const int pr = lane % 8, d0 = ((lane / 8) + 4 * warp) * kTd;
  const bool own_l = d0 == 0;
  auto pv_row = [&](int e) { return (e < 4 ? 0 : 32) + 4 * pr + (e & 3); };
  const float* kh = k + bh * sk * HD;
  const float* vh = v + bh * sk * HD;

  {
    const float* qh = q + (bh * sq + q0) * HD;
    for (int i = tid; i < kRows * HD; i += kThreads) {
      const int r = i / HD, c = i % HD;
      q_sh[r * kLd + c] = q0 + r < sq ? qh[i] : 0.0f;
    }
  }
  float m[8], acc[8][kTd], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int t = 0; t < kTd; ++t) acc[i][t] = 0.0f;
  }

  // The last key block any row of this tile needs (all, without the skip).
  int last = sk / block_k - 1;
  if (causal && skip) last = min(last, (min(q0 + kRows, sq) - 1) / block_k);
  stage<HD>(k_sh, kLd, kh, block_k, vec);
  cp_async_commit();
  for (int kb = 0; kb <= last; ++kb) {
    const int k0 = kb * block_k;
    cp_async_wait_all();
    __syncthreads();                 // K landed; the last block's PV is done
    stage<HD>(v_sh, HD, vh + (long long)k0 * HD, block_k, vec);
    cp_async_commit();

    float s[8][8];
    qk<HD>(s, q_sh, k_sh, rg, kg);
    // Scale, the masks where the block needs them (keys past block_k are
    // not in the block: -inf, out of the max), the block max across the
    // row's 16 threads.
    float mx[8];
    if (block_k < kMaxBlockK || k0 + block_k > sk_real || (causal && k0 + block_k - 1 > q0))
      scale_and_max<true>(s, mx, scale, q0 + rg, k0 + kg, kg, block_k, sk_real, causal);
    else
      scale_and_max<false>(s, mx, scale, q0 + rg, k0 + kg, kg, block_k, sk_real, causal);
    // m_new, corr (to the PV threads through row_sh) and p, in registers.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + rg + 8 * i;
      const float mn = max_nan(m[i], mx[i]);
      const float corr = expf(__fsub_rn(m[i], mn));
      if (kg == 0) row_sh[rg + 8 * i] = corr;
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = expf(__fsub_rn(s[i][j], mn));
      if (!(causal && skip && k0 > row)) m[i] = mn;
    }
    // p of keys [0, kHalfK) to shared memory; PV over them while the next
    // block's K is copied; then the same for keys [kHalfK, block_k).
    store_p<0>(s, p_sh, rg, kg, block_k);
    cp_async_wait_all();
    __syncthreads();                 // V landed; p, corr written; every read of K done
    if (kb < last) {
      stage<HD>(k_sh, kLd, kh + (long long)(k0 + block_k) * HD, block_k, vec);
      cp_async_commit();
    }

    bool run[8];
    bool all = true;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      run[e] = !(causal && skip && k0 > q0 + pv_row(e));
      all = all && run[e];
      if (run[e]) {
        const float corr = row_sh[pv_row(e)];
        l[e] = __fmul_rn(l[e], corr);
#pragma unroll
        for (int t = 0; t < kTd; ++t) acc[e][t] = __fmul_rn(acc[e][t], corr);
      }
    }
    for (int half = 0; half < 2 && kHalfK * half < block_k; ++half) {
      if (half) {
        __syncthreads();             // every read of the first half's p is done
        store_p<1>(s, p_sh, rg, kg, block_k);
        __syncthreads();
      }
      const float* vh_sh = v_sh + kHalfK * half * HD;
      const int n = min(kHalfK, block_k - kHalfK * half);
      if (all)
        pv<HD, true>(acc, l, run, p_sh, vh_sh, pr, d0, n, own_l);
      else
        pv<HD, false>(acc, l, run, p_sh, vh_sh, pr, d0, n, own_l);
    }
  }
  if (own_l) {
#pragma unroll
    for (int e = 0; e < 8; ++e) l_sh[pv_row(e)] = l[e];
  }
  __syncthreads();
  if (tid < kRows) row_sh[tid] = tsdiv::recip_f32_bits(l_sh[tid], table, n_iters, schedule);
  __syncthreads();
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int row = q0 + pv_row(e);
    if (row < sq) {
      float* orow = out + (bh * sq + row) * HD + d0;
      const float rl = row_sh[pv_row(e)];
#pragma unroll
      for (int t = 0; t < kTd; ++t) orow[t] = __fmul_rn(acc[e][t], rl);
    }
  }
}

template <int HD>
cudaError_t prepare() {
  return cudaFuncSetAttribute(flash_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Layout<HD>::kBytes);
}

template <int HD>
int blocks_per_sm(int* blocks) {
  cudaError_t err = prepare<HD>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, flash_kernel<HD>, kThreads,
                                                        Layout<HD>::kBytes);
  return (int)err;
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* out, long long bh, int sq,
           int sk, int sk_real, int block_k, int causal, int skip, float scale,
           TsdivSeedTable table, int n_iters, int schedule, cudaStream_t stream) {
  const cudaError_t err = prepare<HD>();
  if (err != cudaSuccess) return (int)err;
  const int vec = ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const int n_qt = (sq + kRows - 1) / kRows;
  flash_kernel<HD><<<(unsigned int)(bh * n_qt), kThreads, Layout<HD>::kBytes, stream>>>(
      q, k, v, out, sq, sk, sk_real, block_k, n_qt, causal, skip, scale, table, n_iters,
      schedule, vec);
  return (int)cudaGetLastError();
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
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  switch (hd) {
    case 16: return launch<16>(qf, kf, vf, of, bh, sq, sk, sk_real, block_k, causal, skip, scale, table, n_iters, schedule, stream);
    case 32: return launch<32>(qf, kf, vf, of, bh, sq, sk, sk_real, block_k, causal, skip, scale, table, n_iters, schedule, stream);
    case 64: return launch<64>(qf, kf, vf, of, bh, sq, sk, sk_real, block_k, causal, skip, scale, table, n_iters, schedule, stream);
    case 128: return launch<128>(qf, kf, vf, of, bh, sq, sk, sk_real, block_k, causal, skip, scale, table, n_iters, schedule, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The blocks of flash_attention_f32 that one SM holds at once for head size
// hd (occupancy from registers and shared memory), in *blocks; returns the
// CUDA error of the query.
int flash_attention_f32_blocks_per_sm(int hd, int* blocks) {
  switch (hd) {
    case 16: return blocks_per_sm<16>(blocks);
    case 32: return blocks_per_sm<32>(blocks);
    case 64: return blocks_per_sm<64>(blocks);
    case 128: return blocks_per_sm<128>(blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
