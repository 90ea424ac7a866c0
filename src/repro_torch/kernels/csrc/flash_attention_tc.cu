// Hopper kernel of flash attention on bf16 q/k/v with the division unit's
// 1/l, on the tensor cores, with a plain C interface for ctypes (built by
// kernels/_build.py with nvcc -fmad=false for sm_90a).
//
// Replaces the bf16 route of the reference's Pallas TPU kernel
// src/repro/kernels/flash_attention.py flash_attention / _flash_kernel:
// online-softmax attention over (BH, S, hd) with the running max m, sum l and
// output acc updated once per key block, masked scores at NEG_INF = -1e30
// (causal and keys at or past sk_real), early skip of key blocks above the
// diagonal, and the final acc * recip_f32_bits(l). f32 q/k/v keep
// csrc/flash_attention.cu.
//
// Bound: operations. Causal attention at S = 2048, hd = 64 does ~S^2*hd/2
// multiply-adds for QK^T and as many for PV per head against 4 reads and
// writes of (S, hd): far above the ~295 bf16 tensor-core operations per byte
// of HBM bandwidth at which the card stops being memory-bound.
//
// Design (FlashAttention-2's layout on mma.sync): one block of 4 warps per
// (head, 64 query rows), the longest tiles first; each warp owns 16 rows,
// with its Q slice held in registers as m16n8k16 A fragments for the whole
// key loop (at hd = 128, where they would spill, in shared memory, read by
// ldmatrix). K/V tiles of
// block_k keys (padded with masked zero keys to a multiple of 16) stream
// through a two-stage cp.async ring in shared memory, rows padded by 8 bf16
// so that ldmatrix reads them without bank conflicts. Per key block:
//   * S = Q K^T by mma (K through ldmatrix), then * scale, then the causal,
//     sk_real and padding masks at NEG_INF;
//   * the block max across the quad by xor shuffles; corr = expf(m - m_new),
//     p = expf(s - m_new) with libdevice expf;
//   * l = l*corr + rowsum(p), rowsum in one fixed order: each thread over its
//     columns in key order from +0, then an xor-shuffle tree over the quad,
//     (t0 + t1) + (t2 + t3);
//   * acc = acc*corr, then acc += P V by mma with the score fragments re-used
//     as the A operand (V through ldmatrix.trans). p is split into
//     p_hi = bf16(p) and p_lo = bf16(p - p_hi), two mma per 16 keys (hi,
//     then lo), which keeps p to ~2^-17 relative where one bf16 p keeps 2^-9.
// The warp skips a key block that lies wholly above all of its rows (for a
// row inside a running warp such a block leaves the state unchanged bit for
// bit: every p is 0 and corr is 1). The final o = acc * recip_f32_bits(l) is
// stored as bf16, rounded to nearest even. Every rounding outside the mma is
// explicit (-fmad=false) and in the order the plain version
// (kernels/flash_attention.py flash_attention_tc_plain) repeats; inside one
// mma the tensor core's order of the 16-term sum is not documented, so there
// the plain version models exact products summed and rounded once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"
#include "tsdiv_body.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;   // query rows per block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxBlockK = 128;      // MAX_BLOCK_K in kernels/flash_attention.py
constexpr int kMaxTiles = kMaxBlockK / 8;
constexpr int kStages = 2;
// Resident blocks per SM the register budget is cut for (at most 170
// registers a thread). Uncapped, hd = 64 takes 203 registers (2 blocks);
// 3 measured 21% faster at (96, 2048, 64) on the H100 although ptxas then
// spills a few registers at hd = 64 and 128, and 4 measured slower.
constexpr int kMinBlocks = 3;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a * b: one 16x8x16 bf16 product with f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 in one register, the lower column in the lower half.
__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// p_hi = bf16(p), p_lo = bf16(p - p_hi) (the difference is exact in f32).
__device__ __forceinline__ void split(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat16 xh = __float2bfloat16_rn(x), yh = __float2bfloat16_rn(y);
  hi = pack(xh, yh);
  lo = pack(__float2bfloat16_rn(__fsub_rn(x, __bfloat162float(xh))),
            __float2bfloat16_rn(__fsub_rn(y, __bfloat162float(yh))));
}

__device__ __forceinline__ float quad_max(float v) {
  v = rows::nan_max(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return rows::nan_max(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

template <int HD>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    flash_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int sq,
                    int sk, int sk_real, int block_k, int n_qt, int causal, int skip, float scale,
                    const __grid_constant__ TsdivSeedTable table, int n_iters, int schedule) {
  constexpr int kLd = HD + 8;      // shared row stride (bf16): 16-byte rows, no bank conflicts
  constexpr int kSteps = HD / 16;  // k-steps of QK^T, and pairs of output n-tiles
  constexpr int kOut = HD / 8;     // output n-tiles
  constexpr bool kQInSmem = HD > 64;   // at hd = 128 Q's fragments would spill registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int bkp = (block_k + 15) & ~15;   // key rows of a tile, padded to 16
  const int nt = bkp / 8;                 // score n-tiles in use
  auto k_tile = [&](int s) { return smem + (size_t)(2 * s) * bkp * kLd; };
  auto v_tile = [&](int s) { return smem + (size_t)(2 * s + 1) * bkp * kLd; };
  __nv_bfloat16* q_sh = smem + (size_t)2 * kStages * bkp * kLd;   // [kRows][kLd] if kQInSmem

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  // Heads vary fastest and the query tiles run from the last (the most key
  // blocks under the causal mask) to the first, so the last wave holds the
  // cheapest tiles.
  const long long n_bh = gridDim.x / n_qt;
  const long long bh = blockIdx.x % n_bh;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / n_bh)) * kRows;
  const int w0 = q0 + 16 * warp;
  const int r0 = w0 + g, r1 = r0 + 8;     // this thread's two rows
  const bool warp_valid = w0 < sq;
  const int warp_last = min(w0 + 15, sq - 1);
  const __nv_bfloat16* kh = k + bh * sk * HD;
  const __nv_bfloat16* vh = v + bh * sk * HD;

  // The padded key rows [block_k, bkp) of every tile hold zeros; the copies
  // below never write them.
  const int pad_elems = (bkp - block_k) * HD;
  for (int i = tid; i < 2 * kStages * pad_elems; i += kThreads) {
    const int tile = i / pad_elems, rem = i % pad_elems;
    smem[(size_t)tile * bkp * kLd + (block_k + rem / HD) * kLd + rem % HD] = __ushort_as_bfloat16(0);
  }

  // Q as A fragments: in registers for the whole key loop, or (hd = 128) in
  // shared memory, read by ldmatrix at each k-step. Rows past sq are zero.
  const __nv_bfloat16* qh = q + bh * sq * HD;
  uint32_t qa[kQInSmem ? 1 : kSteps][4];
  if constexpr (kQInSmem) {
    for (int i = tid; i < kRows * HD / 8; i += kThreads) {
      const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < sq) w = *reinterpret_cast<const uint4*>(qh + (long long)(q0 + r) * HD + c);
      *reinterpret_cast<uint4*>(q_sh + r * kLd + c) = w;
    }
  } else {
    auto word = [&](int r, int c) -> uint32_t {
      return r < sq ? *reinterpret_cast<const uint32_t*>(qh + (long long)r * HD + c) : 0u;
    };
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const int c = 16 * kk + 2 * tq;
      qa[kk][0] = word(r0, c);
      qa[kk][1] = word(r1, c);
      qa[kk][2] = word(r0, c + 8);
      qa[kk][3] = word(r1, c + 8);
    }
  }
  float acc[kOut][4];
#pragma unroll
  for (int d = 0; d < kOut; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

  auto load = [&](int kb, int s) {
    constexpr int kChunks = HD / 8;       // 16-byte chunks per row
    const long long k0 = (long long)kb * block_k;
    for (int i = tid; i < block_k * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      cp_async16(k_tile(s) + r * kLd + c, kh + (k0 + r) * HD + c);
      cp_async16(v_tile(s) + r * kLd + c, vh + (k0 + r) * HD + c);
    }
  };

  // The last key block any row of this tile needs (all, without the skip).
  int last = sk / block_k - 1;
  if (causal && skip) last = min(last, (min(q0 + kRows, sq) - 1) / block_k);
  load(0, 0);
  cp_async_commit();
  for (int kb = 0; kb <= last; ++kb) {
    const int s = kb & 1;
    if (kb < last) load(kb + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = kb * block_k;
    if (warp_valid && !(causal && skip && k0 > warp_last)) {
      const __nv_bfloat16* kt = k_tile(s);
      const __nv_bfloat16* vt = v_tile(s);
      float sc[kMaxTiles][4];
#pragma unroll
      for (int n = 0; n < kMaxTiles; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
      // S = Q K^T: k-steps in order, 16 keys (two n-tiles) per ldmatrix.
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t a[4];
        if constexpr (kQInSmem) {
          ldmatrix_x4(a, q_sh + (16 * warp + lane % 8 + ((lane / 8) % 2) * 8) * kLd + 16 * kk +
                             (lane / 16) * 8);
        } else {
          a[0] = qa[kk][0];
          a[1] = qa[kk][1];
          a[2] = qa[kk][2];
          a[3] = qa[kk][3];
        }
#pragma unroll
        for (int np = 0; np < kMaxTiles / 2; ++np) {
          if (2 * np < nt) {
            uint32_t b[4];
            ldmatrix_x4(b, kt + (16 * np + (lane / 16) * 8 + lane % 8) * kLd + 16 * kk +
                               ((lane / 8) % 2) * 8);
            mma_bf16(sc[2 * np], a, b[0], b[1]);
            mma_bf16(sc[2 * np + 1], a, b[2], b[3]);
          }
        }
      }
      // Scale, masks (only where the tile reaches past the warp's first row,
      // sk_real or block_k), the block max.
      const bool masked = bkp != block_k || k0 + bkp > sk_real || (causal && k0 + bkp - 1 > w0);
      float mc0 = -INFINITY, mc1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < kMaxTiles; ++n) {
        if (n < nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x0 = __fmul_rn(sc[n][e], scale);
            float x1 = __fmul_rn(sc[n][2 + e], scale);
            if (masked) {
              const int j = 8 * n + 2 * tq + e;
              const int kpos = k0 + j;
              const bool dead = j >= block_k || kpos >= sk_real;
              if (dead || (causal && kpos > r0)) x0 = kNegInf;
              if (dead || (causal && kpos > r1)) x1 = kNegInf;
            }
            sc[n][e] = x0;
            sc[n][2 + e] = x1;
            mc0 = rows::nan_max(mc0, x0);
            mc1 = rows::nan_max(mc1, x1);
          }
        }
      }
      const float mn0 = rows::nan_max(m0, quad_max(mc0));
      const float mn1 = rows::nan_max(m1, quad_max(mc1));
      const float corr0 = expf(__fsub_rn(m0, mn0));
      const float corr1 = expf(__fsub_rn(m1, mn1));
      // p, and each row's sum in key order per thread, then over the quad.
      float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
      for (int n = 0; n < kMaxTiles; ++n) {
        if (n < nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            sc[n][e] = expf(__fsub_rn(sc[n][e], mn0));
            sc[n][2 + e] = expf(__fsub_rn(sc[n][2 + e], mn1));
            rs0 = __fadd_rn(rs0, sc[n][e]);
            rs1 = __fadd_rn(rs1, sc[n][2 + e]);
          }
        }
      }
      l0 = __fadd_rn(__fmul_rn(l0, corr0), quad_sum(rs0));
      l1 = __fadd_rn(__fmul_rn(l1, corr1), quad_sum(rs1));
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int d = 0; d < kOut; ++d) {
        acc[d][0] = __fmul_rn(acc[d][0], corr0);
        acc[d][1] = __fmul_rn(acc[d][1], corr0);
        acc[d][2] = __fmul_rn(acc[d][2], corr1);
        acc[d][3] = __fmul_rn(acc[d][3], corr1);
      }
      // acc += P V: per 16 keys, p_hi then p_lo, into every output n-tile.
#pragma unroll
      for (int kk = 0; kk < kMaxTiles / 2; ++kk) {
        if (2 * kk < nt) {
          uint32_t ah[4], al[4];
          split(sc[2 * kk][0], sc[2 * kk][1], ah[0], al[0]);
          split(sc[2 * kk][2], sc[2 * kk][3], ah[1], al[1]);
          split(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ah[2], al[2]);
          split(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ah[3], al[3]);
          const int key = 16 * kk + ((lane / 8) % 2) * 8 + lane % 8;
#pragma unroll
          for (int dp = 0; dp < kSteps; ++dp) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, vt + key * kLd + 16 * dp + (lane / 16) * 8);
            mma_bf16(acc[2 * dp], ah, b[0], b[1]);
            mma_bf16(acc[2 * dp], al, b[0], b[1]);
            mma_bf16(acc[2 * dp + 1], ah, b[2], b[3]);
            mma_bf16(acc[2 * dp + 1], al, b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();   // the next iteration's copy overwrites this stage
  }
  if (!warp_valid) return;
  const float rl0 = tsdiv::recip_f32_bits(l0, table, n_iters, schedule);
  const float rl1 = tsdiv::recip_f32_bits(l1, table, n_iters, schedule);
  __nv_bfloat16* oh = out + bh * sq * HD;
#pragma unroll
  for (int d = 0; d < kOut; ++d) {
    const int c = 8 * d + 2 * tq;
    if (r0 < sq)
      *reinterpret_cast<uint32_t*>(oh + (long long)r0 * HD + c) =
          pack(__float2bfloat16_rn(__fmul_rn(acc[d][0], rl0)),
               __float2bfloat16_rn(__fmul_rn(acc[d][1], rl0)));
    if (r1 < sq)
      *reinterpret_cast<uint32_t*>(oh + (long long)r1 * HD + c) =
          pack(__float2bfloat16_rn(__fmul_rn(acc[d][2], rl1)),
               __float2bfloat16_rn(__fmul_rn(acc[d][3], rl1)));
  }
}

// The K/V ring (and Q at hd = 128) in dynamic shared memory, and the
// kernel's attribute set to allow it.
template <int HD>
cudaError_t prepare(int block_k, size_t* smem) {
  const int bkp = (block_k + 15) & ~15;
  *smem = ((size_t)kStages * 2 * bkp + (HD > 64 ? kRows : 0)) * (HD + 8) * sizeof(__nv_bfloat16);
  return cudaFuncSetAttribute(flash_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

template <int HD>
int blocks_per_sm(int block_k, int* blocks) {
  size_t smem = 0;
  cudaError_t err = prepare<HD>(block_k, &smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, flash_tc_kernel<HD>, kThreads,
                                                        smem);
  return (int)err;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, long long bh, int sq, int sk,
           int sk_real, int block_k, int causal, int skip, float scale, TsdivSeedTable table,
           int n_iters, int schedule, cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err = prepare<HD>(block_k, &smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (sq + kRows - 1) / kRows;
  flash_tc_kernel<HD><<<(unsigned int)(bh * n_qt), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), sq, sk, sk_real,
      block_k, n_qt, causal, skip, scale, table, n_iters, schedule);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (bh, sq, hd), k/v: (bh, sk, hd), out: (bh, sq, hd), contiguous bf16 on
// 16-byte boundaries; sk a multiple of block_k <= kMaxBlockK; hd in {16, 32,
// 64, 128}. Returns the launch's cudaGetLastError() (cudaErrorInvalidValue
// for a shape or alignment the kernel lacks).
int flash_attention_bf16(const void* q, const void* k, const void* v, void* out, long long bh,
                         int sq, int sk, int sk_real, int hd, int block_k, int causal, int skip,
                         float scale, TsdivSeedTable table, int n_iters, int schedule,
                         cudaStream_t stream) {
  if (block_k < 1 || block_k > kMaxBlockK || sk % block_k != 0) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) & 15 || reinterpret_cast<uintptr_t>(out) & 3)
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16: return launch<16>(q, k, v, out, bh, sq, sk, sk_real, block_k, causal, skip, scale, table, n_iters, schedule, stream);
    case 32: return launch<32>(q, k, v, out, bh, sq, sk, sk_real, block_k, causal, skip, scale, table, n_iters, schedule, stream);
    case 64: return launch<64>(q, k, v, out, bh, sq, sk, sk_real, block_k, causal, skip, scale, table, n_iters, schedule, stream);
    case 128: return launch<128>(q, k, v, out, bh, sq, sk, sk_real, block_k, causal, skip, scale, table, n_iters, schedule, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The blocks of flash_attention_bf16 that one SM holds at once for head
// size hd and block_k (occupancy from registers and shared memory), in
// *blocks; returns the CUDA error of the query.
int flash_attention_bf16_blocks_per_sm(int hd, int block_k, int* blocks) {
  if (block_k < 1 || block_k > kMaxBlockK) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16: return blocks_per_sm<16>(block_k, blocks);
    case 32: return blocks_per_sm<32>(block_k, blocks);
    case 64: return blocks_per_sm<64>(block_k, blocks);
    case 128: return blocks_per_sm<128>(block_k, blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
