// Guarded GMM CDF rows and per-symbol bounds for the interleaved rANS coder,
// the reference format's uint16 boundary rows, and the mixture weights'
// softmax, for Hopper (sm_90a).
//
// gmm_rows_kernel replaces the plain-XLA fusion of
// flashgmm_tpu/ans/gaussian_cdf.py:114 (gmm_guarded_rows; not a Pallas
// kernel): from float32 [N, K] scales, means and weights it writes the int32
// [N, L] rows. gmm_bounds_kernel replaces gmm_guarded_bounds (:150, plain XLA
// too): from int32 [N] symbol values it writes each symbol's (start, freq),
// the two entries that bound its bin. Each entry is gmm::entry
// (gmm_entry.cuh), the arithmetic the decoder's on-demand search evaluates
// too; each APPROX_MODE is a template instance.
//
// gmm_rows_kernel: one block of 128 threads per 32 symbols. The block stages
// the symbols' 3K parameters in shared memory (flushed on the way in), then
// its threads walk the 32 x L entries j fastest, so the int32 stores of a
// warp are contiguous. The bound is the float32 arithmetic, not the bytes:
// each entry evaluates K terms of an IEEE divide, XLA's exp (about 20
// dependent operations) and a square root or a reciprocal, some 125 flops
// an entry at K=4, against 4 bytes written; the design keeps it at one pass
// over the output with every parameter read once from device memory.
//
// gmm_bounds_kernel: one thread per symbol, its parameters in registers, two
// entries (j and j + 1, j = value - lo). It reads 3K + 1 words and writes 2
// a symbol; its 2 entries are about 250 flops at K=4, so on the card it is
// bound by the float32 arithmetic too, a 49th of the full rows' work at
// L=98.
//
// gmm_boundary_rows_kernel replaces the plain-XLA gmm_boundary_rows
// (flashgmm_tpu/ans/gaussian_cdf.py:71; not a Pallas kernel), the device
// half of the reference format's device-rows mode: the uint16 [N, L] rows
// u16(sum_k w_k Phi((lo + j - 0.5 - mu_k) / s_k) * 65535), each entry with
// XLA's CPU roundings (boundary_entry below), so the host coder's streams
// cross between the card, the port on the CPU and the JAX package. Its
// layout is gmm_rows_kernel's; 2 bytes an entry out.
//
// gmm_softmax_kernel computes the mixture weights of every coding path: the
// softmax over K of [outer, K, M] logits in jax.nn.softmax's op order on
// XLA's CPU (max over K, subtract, XLA's exp, a sum over k = 0, 1, ... in
// order, divide), so the card's weights equal the CPU's, and JAX's, bit for
// bit (torch.softmax's CUDA and CPU builds round differently). One thread a
// column (o, m): K loads and K stores at stride M, coalesced over m; it
// moves 8K bytes a column for ~30K flops, so the bytes bound it.
//
// The guarded rows and the bounds are not on the batched codec's main path:
// its decoder evaluates the entries its search probes (rans_kernels.cu,
// GmmRows) and its encoder the two bounds of each symbol (rans_kernels.cu,
// GmmBounds), with the same gmm::entry. They serve gmm_guarded_rows and
// gmm_guarded_bounds on CUDA tensors, the full-rows path that chip_smoke.py
// checks the bytes against, and the smoke's set-ups.

#include <cstdint>
#include <cuda_runtime.h>

#include "gmm_entry.cuh"

namespace {

using gmm::kMaxK;

constexpr int kRowsPerBlock = 32;
constexpr int kThreads = 128;

template <int MODE>
__global__ void __launch_bounds__(kThreads)
gmm_rows_kernel(const float* __restrict__ scales,
                const float* __restrict__ means,
                const float* __restrict__ weights, int N, int K, int lo,
                int L, int* __restrict__ rows) {
  // [param][row][k]: scale, mean and b (gmm::term_b of the weight)
  __shared__ float sp[3][kRowsPerBlock][kMaxK];
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int nrows = min(kRowsPerBlock, N - row0);
  for (int e = threadIdx.x; e < nrows * K; e += kThreads) {
    const int r = e / K, k = e - r * K;
    const size_t g = (size_t)(row0 + r) * K + k;
    sp[0][r][k] = gmm::ftz(scales[g]);
    sp[1][r][k] = gmm::ftz(means[g]);
    sp[2][r][k] = gmm::term_b<MODE>(weights[g]);
  }
  __syncthreads();

  int* out = rows + (size_t)row0 * L;
  for (int e = threadIdx.x; e < nrows * L; e += kThreads) {
    const int r = e / L, j = e - r * L;
    out[e] = gmm::entry<MODE>(sp[0][r], sp[1][r], sp[2][r], K, lo, j, L);
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
gmm_bounds_kernel(const int32_t* __restrict__ values,
                  const float* __restrict__ scales,
                  const float* __restrict__ means,
                  const float* __restrict__ weights, int N, int K, int lo,
                  int L, int32_t* __restrict__ start,
                  int32_t* __restrict__ freq) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= N) return;
  float s[kMaxK] = {}, m[kMaxK] = {}, b[kMaxK] = {};
  const size_t g = (size_t)i * K;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k < K) {
      s[k] = gmm::ftz(scales[g + k]);
      m[k] = gmm::ftz(means[g + k]);
      b[k] = gmm::term_b<MODE>(weights[g + k]);
    }
  }
  const int j = values[i] - lo;
  const int a = gmm::entry<MODE>(s, m, b, K, lo, j, L);
  const int c = gmm::entry<MODE>(s, m, b, K, lo, j + 1, L);
  start[i] = a;
  freq[i] = c - a;
}

// uint16 entry j of a reference-format boundary row: the mixture summed as
// XLA's CPU reduce over K sums it (a0 * b0, then fma(ak, bk, acc) for k >= 1),
// times 65535, then XLA's saturating float -> uint16 convert (NaN -> 0).
template <int MODE>
__device__ __forceinline__ uint16_t boundary_entry(const float* s,
                                                   const float* m,
                                                   const float* b, int K,
                                                   int lo, int j) {
  const float x = __fadd_rn(__fadd_rn((float)lo, -0.5f), (float)j);
  float z[kMaxK], a[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k)
    if (k < K) z[k] = gmm::ftz(__fdiv_rn(__fsub_rn(x, m[k]), s[k]));
  gmm::terms_a<MODE, kMaxK>(z, a, K);
  float acc = gmm::ftz(__fmul_rn(a[0], b[0]));
#pragma unroll
  for (int k = 1; k < kMaxK; ++k)
    if (k < K) acc = gmm::ftz(__fmaf_rn(a[k], b[k], acc));
  const float v = __fmul_rn(acc, 65535.0f);
  if (isnan(v)) return 0;
  return (uint16_t)gmm::clampf(v, 0.0f, 65535.0f);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
gmm_boundary_rows_kernel(const float* __restrict__ scales,
                         const float* __restrict__ means,
                         const float* __restrict__ weights, int N, int K,
                         int lo, int L, uint16_t* __restrict__ rows) {
  __shared__ float sp[3][kRowsPerBlock][kMaxK];
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int nrows = min(kRowsPerBlock, N - row0);
  for (int e = threadIdx.x; e < nrows * K; e += kThreads) {
    const int r = e / K, k = e - r * K;
    const size_t g = (size_t)(row0 + r) * K + k;
    sp[0][r][k] = gmm::ftz(scales[g]);
    sp[1][r][k] = gmm::ftz(means[g]);
    sp[2][r][k] = gmm::term_b<MODE>(weights[g]);
  }
  __syncthreads();

  uint16_t* out = rows + (size_t)row0 * L;
  for (int e = threadIdx.x; e < nrows * L; e += kThreads) {
    const int r = e / L, j = e - r * L;
    out[e] = boundary_entry<MODE>(sp[0][r], sp[1][r], sp[2][r], K, lo, j);
  }
}

__global__ void __launch_bounds__(kThreads)
gmm_softmax_kernel(const float* __restrict__ in, float* __restrict__ out,
                   long long columns, int K, int M) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= columns) return;
  const long long o = i / M;
  const size_t base = (size_t)o * K * M + (size_t)(i - o * M);
  float v[kMaxK];
  float mx = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k < K) {
      v[k] = gmm::ftz(in[base + (size_t)k * M]);
      mx = (k == 0 || v[k] > mx) ? v[k] : mx;
    }
  }
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k < K) {
      v[k] = gmm::xla_exp(gmm::ftz(__fsub_rn(v[k], mx)));
      sum = k == 0 ? v[0] : gmm::ftz(__fadd_rn(sum, v[k]));
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxK; ++k)
    if (k < K) out[base + (size_t)k * M] = gmm::ftz(__fdiv_rn(v[k], sum));
}

bool bad_args(int N, int K, int L, int mode) {
  return N < 1 || K < 1 || K > kMaxK || L < 2 || mode < 0 || mode > 2;
}

}  // namespace

extern "C" int fg_gmm_rows(const void* scales, const void* means,
                           const void* weights, int N, int K, int lo, int L,
                           int mode, void* rows, void* stream) {
  if (bad_args(N, K, L, mode)) return (int)cudaErrorInvalidValue;
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

extern "C" int fg_gmm_bounds(const void* values, const void* scales,
                             const void* means, const void* weights, int N,
                             int K, int lo, int L, int mode, void* start,
                             void* freq, void* stream) {
  if (bad_args(N, K, L, mode)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((N + kThreads - 1) / kThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t* v = (const int32_t*)values;
  const float* sc = (const float*)scales;
  const float* mu = (const float*)means;
  const float* wt = (const float*)weights;
  int32_t* st = (int32_t*)start;
  int32_t* fq = (int32_t*)freq;
  if (mode == 0)
    gmm_bounds_kernel<0><<<blocks, kThreads, 0, s>>>(v, sc, mu, wt, N, K, lo, L, st, fq);
  else if (mode == 1)
    gmm_bounds_kernel<1><<<blocks, kThreads, 0, s>>>(v, sc, mu, wt, N, K, lo, L, st, fq);
  else
    gmm_bounds_kernel<2><<<blocks, kThreads, 0, s>>>(v, sc, mu, wt, N, K, lo, L, st, fq);
  return (int)cudaGetLastError();
}

extern "C" int fg_gmm_boundary_rows(const void* scales, const void* means,
                                    const void* weights, int N, int K, int lo,
                                    int L, int mode, void* rows,
                                    void* stream) {
  if (bad_args(N, K, L, mode)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((N + kRowsPerBlock - 1) / kRowsPerBlock);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* sc = (const float*)scales;
  const float* mu = (const float*)means;
  const float* wt = (const float*)weights;
  uint16_t* out = (uint16_t*)rows;
  if (mode == 0)
    gmm_boundary_rows_kernel<0><<<blocks, kThreads, 0, s>>>(sc, mu, wt, N, K, lo, L, out);
  else if (mode == 1)
    gmm_boundary_rows_kernel<1><<<blocks, kThreads, 0, s>>>(sc, mu, wt, N, K, lo, L, out);
  else
    gmm_boundary_rows_kernel<2><<<blocks, kThreads, 0, s>>>(sc, mu, wt, N, K, lo, L, out);
  return (int)cudaGetLastError();
}

extern "C" int fg_gmm_softmax(const void* in, void* out, long long outer,
                              int K, int M, void* stream) {
  if (outer < 1 || M < 1 || K < 1 || K > kMaxK)
    return (int)cudaErrorInvalidValue;
  const long long columns = outer * M;
  const unsigned blocks = (unsigned)((columns + kThreads - 1) / kThreads);
  gmm_softmax_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, columns, K, M);
  return (int)cudaGetLastError();
}
