// One entry of a guarded GMM CDF row, the arithmetic that every kernel of
// the port needs the rows' integers from: the full-rows kernel
// (gmm_rows.cu: gmm_rows_kernel), the bounds kernel (gmm_rows.cu:
// gmm_bounds_kernel), the encoder's bounds (rans_kernels.cu: the GmmBounds
// record source) and the decoder's on-demand search (rans_kernels.cu: the
// GmmRows row source). They all call gmm::entry, so the encoder's and the
// decoder's integers come from the same code.
//
//   rows[i, j] = floor(clip(cdf_i(lo + j - 0.5), 0, 1) * (65536 - L)) + j,
//   rows[i, L-1] = 65536,
//
// with cdf_i the K-component mixture of the Pólya (APPROX_MODE 0),
// Abramowitz & Stegun (1) or logistic (2) approximation.
//
// Exact rounding is the contract: the entries equal the plain version
// (flashgmm_tpu_torch/ans/gaussian_cdf.py, which is XLA's CPU arithmetic
// written out) and the JAX package's on the CPU. So every float operation
// is the one the plain version performs, with the same rounding: only
// __fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn and __fmaf_rn,
// each where the plain version rounds or where XLA's x86 code contracts a
// multiply into an add (an FMA), so nvcc's default -fmad=true has nothing
// left to fuse. XLA's exp is written out with its constants
// (entropy_models/xla_math.py), and results that can be subnormal are
// flushed to zero as XLA's CPU code flushes them.

#pragma once

#include <cuda_runtime.h>

namespace gmm {

constexpr int kMaxK = 8;  // mixture components an entry takes

constexpr float kMinNormal = 0x1p-126f;
// XLA's CPU exp (xla_math.py)
constexpr float kExpLo = -0x1.5f3334p+6f;
constexpr float kExpHi = 0x1.633334p+6f;
constexpr float kLog2e = 0x1.715476p+0f;
constexpr float kLn2Hi = 0x1.63p-1f;
constexpr float kLn2Lo = -0x1.bd0106p-13f;
constexpr float kExpP0 = 0x1.a0d2cep-13f;
constexpr float kExpP1 = 0x1.6e879cp-10f;
constexpr float kExpP2 = 0x1.111210p-7f;
constexpr float kExpP3 = 0x1.555382p-5f;
constexpr float kExpP4 = 0x1.555554p-3f;
// the CDF approximations (gaussian_cdf.py), as float32
constexpr float kPolyaC = -0x1.45f306p-1f;      // -2/pi
constexpr float kInvSqrt2Pi = 0x1.988454p-2f;
constexpr float kAsP = 0x1.da6712p-3f;          // 0.2316419
constexpr float kAsB0 = 0x1.470bf4p-2f;         // b1
constexpr float kAsB1 = -0x1.6d1f0ep-2f;        // b2
constexpr float kAsB2 = 0x1.c80ef0p+0f;         // b3
constexpr float kAsB3 = -0x1.d23dd4p+0f;        // b4
constexpr float kAsB4 = 0x1.548cdep+0f;         // b5
constexpr float kLogisticK = 0x1.b3b646p+0f;    // 1.702

__device__ __forceinline__ float ftz(float v) {
  return fabsf(v) < kMinNormal ? 0.0f : v;
}

// torch.clamp semantics: NaN passes through.
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

// XLA's CPU float32 exp, op for op as xla_math.exp.
__device__ __forceinline__ float xla_exp(float x) {
  x = clampf(x, kExpLo, kExpHi);
  const float n = clampf(floorf(__fmaf_rn(x, kLog2e, 0.5f)), -127.0f, 127.0f);
  const float r = __fmaf_rn(-n, kLn2Lo, __fmaf_rn(-n, kLn2Hi, x));
  float y = __fmaf_rn(r, kExpP0, kExpP1);
  y = __fmaf_rn(y, r, kExpP2);
  y = __fmaf_rn(y, r, kExpP3);
  y = __fmaf_rn(y, r, kExpP4);
  y = __fmaf_rn(y, r, 0.5f);
  y = __fadd_rn(__fmaf_rn(y, __fmul_rn(r, r), r), 1.0f);
  const float scale = __int_as_float(((int)n + 127) << 23);
  return ftz(__fmul_rn(y, scale));
}

// The CDF parts a[k] of the mixture terms a * b (see gaussian_cdf._TERM_A)
// from z[k] = (x - mean_k) / scale_k, k < K. Written in phases over k (every
// term's first step, then every term's next step): IEEE divides and square
// roots carry a rarely taken slow-path branch, which ends a basic block, so
// code written term by term would run the terms one after another; in
// phases the branch-free work of all K terms (XLA's exp above all) shares a
// block and interleaves. Each term's operations, and so its bits, are the
// same in any order.
template <int MODE, int N>
__device__ __forceinline__ void terms_a(const float* z, float* a, int K) {
  if (MODE == 0) {  // 1 + sign(z) sqrt(1 - exp(-2 z^2 / pi))
    float e[N];
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (k < K) e[k] = xla_exp(ftz(__fmul_rn(ftz(__fmul_rn(z[k], z[k])),
                                              kPolyaC)));
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (k < K) {
        float om = __fsub_rn(1.0f, e[k]);
        om = om < 0.0f ? 0.0f : om;
        const float r = __fsqrt_rn(om);
        a[k] = __fadd_rn(1.0f, signbit(z[k]) ? -r : r);
      }
    }
  } else if (MODE == 1) {  // A&S 26.2.17
    float t[N], pdf[N];
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (k < K) t[k] = __fdiv_rn(1.0f, __fmaf_rn(fabsf(z[k]), kAsP, 1.0f));
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (k < K)
        pdf[k] = ftz(__fmul_rn(xla_exp(ftz(__fmul_rn(
                                   ftz(__fmul_rn(z[k], -0.5f)), z[k]))),
                               kInvSqrt2Pi));
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (k < K) {
        float q = __fmaf_rn(t[k], kAsB4, kAsB3);
        q = __fmaf_rn(t[k], q, kAsB2);
        q = __fmaf_rn(t[k], q, kAsB1);
        q = __fmaf_rn(t[k], q, kAsB0);
        const float res = __fmaf_rn(-pdf[k], ftz(__fmul_rn(t[k], q)), 1.0f);
        a[k] = z[k] >= 0.0f ? res : __fsub_rn(1.0f, res);
      }
    }
  } else {  // sigmoid(1.702 z), XLA's logistic
    float d[N];
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (k < K) d[k] = __fadd_rn(xla_exp(-ftz(__fmul_rn(z[k], kLogisticK))),
                                  1.0f);
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (k < K) a[k] = ftz(__fdiv_rn(1.0f, d[k]));
  }
}

// The part b of a mixture term from a raw weight: flushed, and halved in
// Pólya mode (XLA rewrites w * 0.5 * (1 + c) as (1 + c) * (w * 0.5)).
// Scales and means enter flushed (ftz).
template <int MODE>
__device__ __forceinline__ float term_b(float w) {
  w = ftz(w);
  return MODE == 0 ? ftz(__fmul_rn(w, 0.5f)) : w;
}

// rows[i, j] of one symbol from its K flushed scales s, flushed means m and
// term_b weights b (arrays of at least K, or pointers to K values; the loops
// are unrolled with constant indices, so register arrays stay in registers).
// j == L - 1 is the guard 65536; any other j takes the formula, also
// outside [0, L - 1] (the plain version does the same).
//
// KC > 0 fixes K = KC at compile time, so the loops over k have no guards;
// KC = 0 takes any K <= kMaxK. The operations, and so the bits, are the
// same either way.
template <int MODE, int KC = 0>
__device__ __forceinline__ int entry(const float* s, const float* m,
                                     const float* b, int K, int lo, int j,
                                     int L) {
  constexpr int N = KC > 0 ? KC : kMaxK;
  if (KC > 0) K = KC;
  if (j == L - 1) return 65536;
  const float x = __fadd_rn(__fadd_rn((float)lo, -0.5f), (float)j);
  float z[N], a[N];
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (k < K) z[k] = ftz(__fdiv_rn(__fsub_rn(x, m[k]), s[k]));
  terms_a<MODE, N>(z, a, K);
  float acc = ftz(__fmul_rn(a[0], b[0]));  // the K = 1 result
  if (K > 1)  // fma(a0, b0, a1 * b1)
    acc = ftz(__fmaf_rn(a[0], b[0], ftz(__fmul_rn(a[1], b[1]))));
#pragma unroll
  for (int k = 2; k < N; ++k)
    if (k < K) acc = ftz(__fmaf_rn(a[k], b[k], acc));
  const float v = floorf(__fmul_rn(clampf(acc, 0.0f, 1.0f),
                                   (float)(65536 - L)));
  return (isnan(v) ? 0 : (int)v) + j;
}

}  // namespace gmm
