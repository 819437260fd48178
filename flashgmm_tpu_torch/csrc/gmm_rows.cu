// Guarded GMM CDF rows for the interleaved rANS coder, one fused kernel for
// Hopper (sm_90a).
//
// Replaces the plain-XLA fusion of flashgmm_tpu/ans/gaussian_cdf.py:114
// (gmm_guarded_rows; not a Pallas kernel). From float32 [N, K] scales, means
// and weights it writes int32 [N, L]:
//   rows[i, j] = floor(clip(cdf_i(lo + j - 0.5), 0, 1) * (65536 - L)) + j,
//   rows[i, L-1] = 65536,
// with cdf_i the K-component mixture of the Pólya (APPROX_MODE 0),
// Abramowitz & Stegun (1) or logistic (2) approximation, each mode a
// template instance.
//
// Exact rounding is the contract: the encoder and the decoder must compute
// the same integers, and they equal the JAX package's on the CPU. So every
// float operation is the one the plain version (flashgmm_tpu_torch/ans/
// gaussian_cdf.py, which is XLA's CPU arithmetic written out) performs, with
// the same rounding: only __fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn,
// __fsqrt_rn and __fmaf_rn, each where the plain version rounds or where
// XLA's x86 code contracts a multiply into an add (an FMA), so nvcc's
// default -fmad=true has nothing left to fuse. XLA's exp is written out with
// its constants (entropy_models/xla_math.py), and results that can be
// subnormal are flushed to zero as XLA's CPU code flushes them.
//
// Layout: one block of 128 threads per 32 symbols. The block stages the
// symbols' 3K parameters in shared memory (flushed on the way in), then its
// threads walk the 32 x L entries j fastest, so the int32 stores of a warp
// are contiguous. The bound is the float32 arithmetic, not the bytes: each
// entry evaluates K terms of an IEEE divide, XLA's exp (about 20 dependent
// operations) and a square root or a reciprocal, some 125 flops an entry at
// K=4, against 4 bytes written; the design keeps it at one pass over the
// output with every parameter read once from device memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 32;
constexpr int kThreads = 128;
constexpr int kMaxK = 8;

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

// The CDF part a of a mixture term a * b (see gaussian_cdf._TERM_A).
template <int MODE>
__device__ __forceinline__ float term_a(float z) {
  if (MODE == 0) {  // 1 + sign(z) sqrt(1 - exp(-2 z^2 / pi))
    const float e = xla_exp(ftz(__fmul_rn(ftz(__fmul_rn(z, z)), kPolyaC)));
    float om = __fsub_rn(1.0f, e);
    om = om < 0.0f ? 0.0f : om;
    const float s = __fsqrt_rn(om);
    return __fadd_rn(1.0f, signbit(z) ? -s : s);
  } else if (MODE == 1) {  // A&S 26.2.17
    const float t = __fdiv_rn(1.0f, __fmaf_rn(fabsf(z), kAsP, 1.0f));
    float q = __fmaf_rn(t, kAsB4, kAsB3);
    q = __fmaf_rn(t, q, kAsB2);
    q = __fmaf_rn(t, q, kAsB1);
    q = __fmaf_rn(t, q, kAsB0);
    const float pdf = ftz(__fmul_rn(
        xla_exp(ftz(__fmul_rn(ftz(__fmul_rn(z, -0.5f)), z))), kInvSqrt2Pi));
    const float res = __fmaf_rn(-pdf, ftz(__fmul_rn(t, q)), 1.0f);
    return z >= 0.0f ? res : __fsub_rn(1.0f, res);
  } else {  // sigmoid(1.702 z), XLA's logistic
    const float u = ftz(__fmul_rn(z, kLogisticK));
    return ftz(__fdiv_rn(1.0f, __fadd_rn(xla_exp(-u), 1.0f)));
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
gmm_rows_kernel(const float* __restrict__ scales,
                const float* __restrict__ means,
                const float* __restrict__ weights, int N, int K, int lo,
                int L, int* __restrict__ rows) {
  // [param][row][k]: scale, mean and b (the weight, halved in Pólya mode)
  __shared__ float sp[3][kRowsPerBlock][kMaxK];
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int nrows = min(kRowsPerBlock, N - row0);
  for (int e = threadIdx.x; e < nrows * K; e += kThreads) {
    const int r = e / K, k = e - r * K;
    const size_t g = (size_t)(row0 + r) * K + k;
    sp[0][r][k] = ftz(scales[g]);
    sp[1][r][k] = ftz(means[g]);
    const float w = ftz(weights[g]);
    sp[2][r][k] = MODE == 0 ? ftz(__fmul_rn(w, 0.5f)) : w;
  }
  __syncthreads();

  const float x0 = __fadd_rn((float)lo, -0.5f);
  const float qscale = (float)(65536 - L);
  int* out = rows + (size_t)row0 * L;
  for (int e = threadIdx.x; e < nrows * L; e += kThreads) {
    const int r = e / L, j = e - r * L;
    if (j == L - 1) {
      out[e] = 65536;
      continue;
    }
    const float x = __fadd_rn(x0, (float)j);
    float acc = 0.0f, first_a = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float z = ftz(__fdiv_rn(__fsub_rn(x, sp[1][r][k]), sp[0][r][k]));
      const float a = term_a<MODE>(z);
      const float b = sp[2][r][k];
      if (k == 0) {
        first_a = a;
        acc = ftz(__fmul_rn(a, b));  // the K = 1 result
      } else if (k == 1) {  // fma(a0, b0, a1 * b1)
        acc = ftz(__fmaf_rn(first_a, sp[2][r][0], ftz(__fmul_rn(a, b))));
      } else {
        acc = ftz(__fmaf_rn(a, b, acc));
      }
    }
    const float v = floorf(__fmul_rn(clampf(acc, 0.0f, 1.0f), qscale));
    out[e] = (isnan(v) ? 0 : (int)v) + j;
  }
}

}  // namespace

extern "C" int fg_gmm_rows(const void* scales, const void* means,
                           const void* weights, int N, int K, int lo, int L,
                           int mode, void* rows, void* stream) {
  if (N < 1 || K < 1 || K > kMaxK || L < 2 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((N + kRowsPerBlock - 1) / kRowsPerBlock);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* sc = (const float*)scales;
  const float* mu = (const float*)means;
  const float* wt = (const float*)weights;
  int* out = (int*)rows;
  if (mode == 0)
    gmm_rows_kernel<0><<<blocks, kThreads, 0, s>>>(sc, mu, wt, N, K, lo, L, out);
  else if (mode == 1)
    gmm_rows_kernel<1><<<blocks, kThreads, 0, s>>>(sc, mu, wt, N, K, lo, L, out);
  else
    gmm_rows_kernel<2><<<blocks, kThreads, 0, s>>>(sc, mu, wt, N, K, lo, L, out);
  return (int)cudaGetLastError();
}
