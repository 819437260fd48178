// Direct stride-1 "same" KxK convolution over NHWC in float32 for Hopper
// (sm_90a), with bias, LeakyReLU and a residual add fused into the epilogue.
//
// Replaces the Pallas TPU kernel flashgmm_tpu/ops/pallas_conv.py::
// _conv_kernel on the rows chain (h_s, the masked context conv and the 1x1
// entropy-parameter convs), where its job is bitwise reproducibility, not
// speed: the encoder and the decoder must compute the same CDF rows.
//
// Each thread owns one output channel of kPix neighbouring output pixels of
// one row and accumulates every output in the fixed order (dy, dx, c_in)
// with explicit fmaf into its own float32 register. So the bits of an output
// depend only on its input neighbourhood and the weights: not on the batch
// size, the grid, the surrounding code or any choice made at run time.
// Out-of-image taps are skipped, as zero padding would add exact zeros.
// Neighbouring threads take neighbouring output channels, so weight reads
// (HWIO) coalesce and input reads broadcast within a warp.
// Bound on the card: float32 FMA issue (no tensor cores in float32) and the
// weight reads of each tap; a tiled shared-memory version is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPix = 4;

__global__ void conv2d_nhwc_kernel(const float* __restrict__ x,
                                   const float* __restrict__ w,
                                   const float* __restrict__ bias,
                                   const float* __restrict__ res,
                                   float* __restrict__ y, int N, int H,
                                   int Wd, int Cin, int Cout, int K,
                                   int leaky, float neg_slope) {
  const int groups = (Wd + kPix - 1) / kPix;
  const long long total = (long long)N * H * groups * Cout;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= total) return;
  const int co = (int)(g % Cout);
  long long rest = g / Cout;
  const int wg = (int)(rest % groups);
  rest /= groups;
  const int h = (int)(rest % H);
  const int n = (int)(rest / H);
  const int w0 = wg * kPix;
  const int p = K / 2;

  float acc[kPix];
#pragma unroll
  for (int q = 0; q < kPix; ++q) acc[q] = 0.0f;

  for (int dy = 0; dy < K; ++dy) {
    const int iy = h + dy - p;
    if (iy < 0 || iy >= H) continue;
    const float* xrow = x + ((size_t)n * H + iy) * (size_t)Wd * Cin;
    for (int dx = 0; dx < K; ++dx) {
      const float* wp = w + (size_t)(dy * K + dx) * Cin * Cout + co;
      const float* xp[kPix];
      bool ok[kPix];
#pragma unroll
      for (int q = 0; q < kPix; ++q) {
        const int ix = w0 + q + dx - p;
        ok[q] = (w0 + q < Wd) && ix >= 0 && ix < Wd;
        xp[q] = xrow + (size_t)(ok[q] ? ix : 0) * Cin;
      }
      for (int ci = 0; ci < Cin; ++ci) {
        const float wv = wp[(size_t)ci * Cout];
#pragma unroll
        for (int q = 0; q < kPix; ++q) {
          if (ok[q]) acc[q] = fmaf(xp[q][ci], wv, acc[q]);
        }
      }
    }
  }

  const float b = bias != nullptr ? bias[co] : 0.0f;
#pragma unroll
  for (int q = 0; q < kPix; ++q) {
    const int ox = w0 + q;
    if (ox >= Wd) continue;
    float v = acc[q];
    if (bias != nullptr) v = v + b;
    if (leaky) v = v >= 0.0f ? v : neg_slope * v;
    const size_t o = (((size_t)n * H + h) * Wd + ox) * Cout + co;
    if (res != nullptr) v = v + res[o];
    y[o] = v;
  }
}

}  // namespace

extern "C" int fg_conv2d_nhwc(const void* x, const void* w, const void* bias,
                              const void* res, void* y, int N, int H, int Wd,
                              int Cin, int Cout, int K, int leaky,
                              float neg_slope, void* stream) {
  if (K < 1 || K % 2 == 0) return (int)cudaErrorInvalidValue;
  const long long groups = (Wd + kPix - 1) / kPix;
  const long long total = (long long)N * H * groups * Cout;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  conv2d_nhwc_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)bias, (const float*)res,
      (float*)y, N, H, Wd, Cin, Cout, K, leaky, neg_slope);
  return (int)cudaGetLastError();
}
