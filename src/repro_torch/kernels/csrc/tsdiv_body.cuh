// Device bodies of the fused division unit: reciprocal, divide and rsqrt on
// raw f32 bits. Each function gives the bits of its plain PyTorch version in
// kernels/common.py, which in turn reproduces the reference's Pallas kernel
// bodies (src/repro/kernels/common.py). It mirrors it operation for
// operation but in two places, where another route reaches the same value:
// the seed's segment select (pwl_seed) and the error-free product
// (two_product).
//
// Rounding is pinned by construction: this file is compiled with
// -fmad=false, so no multiply and add are fused unless written here as
// __fmaf_rn. Those explicit sites are exactly where the compiled reference
// contracts x + a*b (a product with no other use): the seed's
// slope*man + intercept, the series updates, y0 + y0*s, the Goldschmidt
// n + n*r, the Markstein q0 + res*rman and the three Newton sites
// (two_product's error term is an fma too: there it is exact, see below).
// Subnormals are kept by the hardware (no -ftz), so every flush below is
// explicit.
#pragma once

#include <stdint.h>

#define TSDIV_MAX_SEGMENTS 32
#define TSDIV_MAX_TERMS 16

enum TsdivSchedule { TSDIV_PAPER = 0, TSDIV_FACTORED = 1, TSDIV_GOLDSCHMIDT = 2 };

// The seed "ROM": passed to the kernel by value as a __grid_constant__
// argument (it stays in parameter space). Segment i covers
// [inner[i-1], inner[i]).
struct TsdivSeedTable {
  float slopes[TSDIV_MAX_SEGMENTS];
  float intercepts[TSDIV_MAX_SEGMENTS];
  float inner[TSDIV_MAX_SEGMENTS - 1];
};

namespace tsdiv {

constexpr uint32_t kSign = 0x80000000u;
constexpr uint32_t kMag = 0x7FFFFFFFu;
constexpr uint32_t kExpMask = 0x7F800000u;
constexpr uint32_t kManMask = 0x007FFFFFu;
constexpr uint32_t kOneBits = 0x3F800000u;
constexpr uint32_t kNanBits = 0x7FC00000u;
constexpr float kTiny = 1.17549435e-38f;  // 2^-126

__device__ __forceinline__ float bits_f(uint32_t b) { return __uint_as_float(b); }
__device__ __forceinline__ uint32_t f_bits(float f) { return __float_as_uint(f); }

// floor(v / 2) for any int, without relying on >> of a negative value.
__device__ __forceinline__ int floor_half(int v) { return v >= 0 ? v / 2 : -((1 - v) / 2); }

// Segment select by binary search over the inner boundaries, then one fused
// slope*man + intercept. Segment i covers [inner[i-1], inner[i]), so the
// segment of man is the count of inner boundaries <= man. The boundaries are
// non-decreasing and the slots past the table's own hold +inf (the host
// fills them, kernels/tsdiv.py _table_c), so five halving steps over the 31
// slots find that count, branch-free, where a ladder takes n_segments - 1
// compares (15 for the rsqrt table). (Starting at the table's own largest power of two,
// 4 steps for 16 segments, measured slower on the H100: the uniform guard
// costs more than the steps it saves.) It selects the same segment as the
// reference's sum(man >= inner) for every man (tests/test_torch_flash_tc.py
// checks it exhaustively over the mantissas of the tables the port builds).
// The table may sit in parameter space (a __grid_constant__ kernel argument:
// indexed loads, no local copy) or in shared memory (stage_table).
__device__ __forceinline__ int seed_segment(float man, const TsdivSeedTable& t) {
  int pos = 0;
#pragma unroll
  for (int step = TSDIV_MAX_SEGMENTS / 2; step > 0; step >>= 1) {
    if (man >= t.inner[pos + step - 1]) pos += step;
  }
  return pos;
}

__device__ __forceinline__ float pwl_seed(float man, const TsdivSeedTable& t) {
  const int i = seed_segment(man, t);
  return __fmaf_rn(t.slopes[i], man, t.intercepts[i]);
}

// The block's copy of the seed table in shared memory, one word a thread;
// the caller synchronises before use.
__device__ __forceinline__ void stage_table(TsdivSeedTable* dst, const TsdivSeedTable& src) {
  constexpr int kWords = sizeof(TsdivSeedTable) / sizeof(int);
  const int* s = reinterpret_cast<const int*>(&src);
  int* d = reinterpret_cast<int*>(dst);
  for (int i = threadIdx.x; i < kWords; i += blockDim.x) d[i] = s[i];
}

// Error-free product: a*b == p + e, with e = fma(a, b, -p), the exact
// a*b - p rounded once (it is representable). The plain versions compute e by
// the Dekker/Veltkamp split (core/fpparts.py two_product), which is the same
// exact value wherever neither form underflows or overflows. Every call site
// here multiplies operands in [0.5, 2] (mantissas, seeds, their products and
// the Newton iterates), so the two forms give the same bits on every call.
__device__ __forceinline__ void two_product(float a, float b, float& p, float& e) {
  p = __fmul_rn(a, b);
  e = __fmaf_rn(a, b, -p);
}

__device__ __forceinline__ float exact_residual(float man, float y0) {
  float p, e;
  two_product(man, y0, p, e);
  return __fsub_rn(__fsub_rn(1.0f, p), e);
}

// j = ceil(log2(n + 1)), at least 1: factored terms and Goldschmidt iterations.
__device__ __forceinline__ int log_depth(int n) {
  int j = 1;
  while ((1 << j) < n + 1) ++j;
  return j;
}

// s = sum_{k=1}^{n'} m^k without the leading 1.
__device__ __forceinline__ float series_sum(float m, int n, int schedule) {
  if (schedule == TSDIV_FACTORED) {
    const int j = log_depth(n);
    float s = m, t = __fmul_rn(m, m);
    for (int i = 0; i < j - 1; ++i) {
      s = __fmaf_rn(t, __fadd_rn(1.0f, s), s);
      t = __fmul_rn(t, t);
    }
    return s;
  }
  // paper (§6 powering unit): m^k = (m^(k/2))^2 for even k, m * m^(k-1) for
  // odd k. A power is a leaf (its product fuses into the sum's add) when no
  // later power is built from it: 2k > n, and k odd or k + 1 > n.
  float p[TSDIV_MAX_TERMS + 1];
  p[1] = m;
  float s = m;
#pragma unroll
  for (int k = 2; k <= TSDIV_MAX_TERMS; ++k) {
    if (k > n) break;
    const float fa = (k % 2 == 0) ? p[k / 2] : m;
    const float fb = (k % 2 == 0) ? p[k / 2] : p[k - 1];
    p[k] = __fmul_rn(fa, fb);
    const bool leaf = 2 * k > n && (k % 2 == 1 || k + 1 > n);
    s = leaf ? __fmaf_rn(fa, fb, s) : __fadd_rn(s, p[k]);
  }
  return s;
}

// Goldschmidt residual-register recurrence: N <- N + N*r, r <- r*r.
__device__ __forceinline__ float goldschmidt(float num0, float man_b, float y0, int iters) {
  float r = exact_residual(man_b, y0);
  float n = num0;
  for (int i = 0; i < iters; ++i) {
    n = __fmaf_rn(n, r, n);
    r = __fmul_rn(r, r);
  }
  return n;
}

__device__ __forceinline__ float series_refine(float y0, float man, int n, int schedule) {
  if (n <= 0) return y0;
  if (schedule == TSDIV_GOLDSCHMIDT) return goldschmidt(y0, man, y0, log_depth(n));
  return __fmaf_rn(y0, series_sum(exact_residual(man, y0), n, schedule), y0);
}

__device__ __forceinline__ float recip_f32_bits(float x, const TsdivSeedTable& t, int n,
                                                int schedule) {
  const uint32_t bits = f_bits(x);
  const uint32_t sign = bits & kSign;
  const int exp = (int)((bits >> 23) & 0xFFu);
  const uint32_t man_bits = bits & kManMask;
  const float man = bits_f(man_bits | kOneBits);
  const float rman = series_refine(pwl_seed(man, t), man, n, schedule);
  // 2^-(exp-127) has biased exponent 254 - exp (clamped; the edge lanes
  // exp = 0 and exp = 255 are overwritten below).
  const int scale_exp = min(max(254 - exp, 0), 254);
  float r = __fmul_rn(rman, bits_f((uint32_t)scale_exp << 23));
  if (fabsf(r) < kTiny) r = 0.0f;                      // FTZ, explicit
  if (exp == 0) r = bits_f(kExpMask);                  // zero/subnormal -> inf
  if (exp == 255 && man_bits == 0) r = 0.0f;           // inf -> 0
  r = bits_f(f_bits(r) | sign);
  if (exp == 255 && man_bits != 0) r = bits_f(kNanBits);
  return r;
}

__device__ __forceinline__ float pow2(int k) {
  return bits_f((uint32_t)min(max(k + 127, 1), 254) << 23);
}

__device__ __forceinline__ float divide_f32_bits(float a, float b, const TsdivSeedTable& t,
                                                 int n, int schedule) {
  const uint32_t abits = f_bits(a), bbits = f_bits(b);
  const uint32_t sign = (abits ^ bbits) & kSign;
  const int ea = (int)((abits >> 23) & 0xFFu);
  const int eb = (int)((bbits >> 23) & 0xFFu);
  const uint32_t amant = abits & kManMask, bmant = bbits & kManMask;
  const float man_a = bits_f(amant | kOneBits);
  const float man_b = bits_f(bmant | kOneBits);
  const float y0 = pwl_seed(man_b, t);
  float q_man;
  if (schedule == TSDIV_GOLDSCHMIDT) {
    q_man = goldschmidt(__fmul_rn(man_a, y0), man_b, y0, log_depth(n));
  } else {
    const float rman = series_refine(y0, man_b, n, schedule);
    const float q0 = __fmul_rn(man_a, rman);
    float p, e;
    two_product(q0, man_b, p, e);
    const float res = __fsub_rn(__fsub_rn(man_a, p), e);
    q_man = __fmaf_rn(res, rman, q0);                   // Markstein correction
  }
  // q = q_man * 2^(ea-eb) in two power-of-two steps, so neither overflows.
  const int de = ea - eb;
  const int h = floor_half(de);
  float q = __fmul_rn(__fmul_rn(q_man, pow2(h)), pow2(de - h));
  if (fabsf(q) < kTiny) q = 0.0f;                      // FTZ
  const bool a_zero = ea == 0, b_zero = eb == 0;
  const bool a_inf = ea == 255 && amant == 0, b_inf = eb == 255 && bmant == 0;
  if (b_zero) q = bits_f(kExpMask);                    // x/0 -> inf
  if (a_zero) q = 0.0f;                                // 0/x -> 0
  if (a_inf) q = bits_f(kExpMask);                     // inf/x -> inf
  if (b_inf) q = 0.0f;                                 // x/inf -> 0
  if ((a_zero && b_zero) || (a_inf && b_inf)) q = bits_f(kNanBits);
  q = bits_f(f_bits(q) | sign);
  if ((ea == 255 && amant != 0) || (eb == 255 && bmant != 0)) q = bits_f(kNanBits);
  return q;
}

// Newton on y ~ rsqrt(u); the last step's residual 1 - u*y^2 is error-free.
__device__ __forceinline__ float newton_rsqrt(float u, float y, int iters) {
  for (int i = 0; i < iters - 1; ++i) {
    const float t = __fmul_rn(__fmul_rn(0.5f, u), y);
    y = __fmul_rn(y, __fmaf_rn(-t, y, 1.5f));
  }
  if (iters > 0) {
    float hp, he, p2, e2;
    two_product(y, y, hp, he);
    two_product(u, hp, p2, e2);
    const float r = __fmaf_rn(-u, he, __fsub_rn(__fsub_rn(1.0f, p2), e2));
    y = __fmaf_rn(y, __fmul_rn(0.5f, r), y);
  }
  return y;
}

__device__ __forceinline__ float rsqrt_f32_bits(float x, const TsdivSeedTable& t,
                                                int newton_iters) {
  const uint32_t bits = f_bits(x);
  const uint32_t sign = bits & kSign;
  const uint32_t mag = bits & kMag;
  const int exp = (int)((bits >> 23) & 0xFFu);
  const bool x_zero = exp == 0;                        // FTZ zero class
  const bool x_inf = mag == kExpMask;
  const bool x_nan = mag > kExpMask;
  const float man = bits_f((bits & kManMask) | kOneBits);
  const int ef = exp - 127 + 1;                        // |x| = (man/2) * 2^ef
  const int s = floor_half(ef);
  const float u = (ef - 2 * s == 1) ? man : __fmul_rn(man, 0.5f);   // [0.5, 2)
  const float y = newton_rsqrt(u, pwl_seed(u, t), newton_iters);
  float r = __fmul_rn(y, bits_f((uint32_t)min(max(127 - s, 1), 254) << 23));
  if (x_zero) r = bits_f(kExpMask | sign);             // +-0/sub -> +-inf
  if (x_inf) r = 0.0f;                                 // +inf -> +0
  if ((sign != 0 && !x_zero) || x_nan) r = bits_f(kNanBits);
  return r;
}

// rsqrt for strictly positive normal x: the norms' variant (no edge classes;
// the caller pins them). Unlike rsqrt_f32_bits the exponent is unbiased
// without the frexp +1, u = (odd ? man*2 : man) * 0.5, and the result is
// (y * (1/sqrt 2)) * 2^-s with two roundings. Mirrors common.rsqrt_f32.
__device__ __forceinline__ float rsqrt_f32(float x, const TsdivSeedTable& t, int newton_iters) {
  const uint32_t bits = f_bits(x);
  const int exp = (int)((bits >> 23) & 0xFFu) - 127;
  const float man = bits_f((bits & kManMask) | kOneBits);
  const int s = floor_half(exp);
  const float u = __fmul_rn(exp - 2 * s == 1 ? __fmul_rn(man, 2.0f) : man, 0.5f);
  const float y = newton_rsqrt(u, pwl_seed(u, t), newton_iters);
  const float inv_sqrt2 = 0.70710678118654752f;
  return __fmul_rn(__fmul_rn(y, inv_sqrt2), bits_f((uint32_t)min(max(127 - s, 1), 254) << 23));
}

}  // namespace tsdiv
