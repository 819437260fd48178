// Stride-1 "same" KxK convolution over NHWC in float32 for Hopper (sm_90a),
// as an implicit GEMM, with bias, LeakyReLU and a residual add fused into
// the epilogue.
//
// Replaces the Pallas TPU kernel flashgmm_tpu/ops/pallas_conv.py::
// _conv_kernel on the rows chain (h_s, the masked context conv and the 1x1
// entropy-parameter convs), where its first job is bitwise reproducibility:
// the encoder and the decoder must compute the same CDF rows.
//
// The GEMM: M = output pixels (N*H*W), N = C_out, and the reduction runs over
// k = (dy, dx, c_in), which is the row index of the HWIO weights seen as a
// [K*K*C_in, C_out] matrix. A block computes a BM x BN tile of outputs; each
// of its threads holds TM x TN of them in registers. Tiles of BK = 16 k's are
// staged in shared memory with cp.async, kStages = 4 deep (three tiles in
// flight while one is multiplied, to cover the load latency): the input tile is
// gathered straight from the NHWC image (im2col on the fly; taps outside the
// image are zero-filled by the copy), the weight tile is contiguous in C_out.
// With C_in and C_out multiples of 4 (every rows-chain shape) each copy is
// 16 bytes; otherwise the same kernel copies 4 bytes at a time.
//
// Batch invariance and repeatability: every output is ONE float32 fmaf chain
// over k = 0, 1, ..., K*K*C_in - 1 in that order, starting from +0, in one
// thread's register. No split-K, no atomics, no tensor cores. The tile shape
// is chosen from the problem's shape (small tiles for the small rows-chain
// layers, so they still fill the card), but it only decides which thread
// owns an output, never the order of its sum, so an output's bits depend
// only on its input neighbourhood and the weights. Zero-filled taps add
// fmaf(0, w, acc) == acc exactly (acc starts at +0 and an exact zero sum is
// +0), so the bits are those of a chain that skips them.
//
// What bounds it on the card: float32 FMA issue on the CUDA cores (2*M*N*k
// flops at 67 TFLOP/s) for all rows-chain shapes; the register tiles give
// TM*TN FMAs for every (TM + TN) values read from shared memory, and each
// input and weight value is read from device memory once per tile, not once
// per output.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBK = 16;
constexpr int kStages = 4;  // cp.async pipeline depth, in tiles of kBK k's

struct ConvArgs {
  const float* x;
  const float* w;
  const float* bias;
  const float* res;
  float* y;
  int N, H, W, Cin, Cout, K, leaky;
  float neg_slope;
};

// cp.async of VW floats; with valid == false nothing is read and the
// destination is zero-filled.
template <int VW>
__device__ __forceinline__ void cp_async(float* smem, const float* gmem,
                                         bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 4 * VW : 0;
  if constexpr (VW == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float epilogue(const ConvArgs& a, float v, int co,
                                          size_t o) {
  if (a.bias != nullptr) v = __fadd_rn(v, a.bias[co]);
  if (a.leaky) v = v >= 0.0f ? v : __fmul_rn(a.neg_slope, v);
  if (a.res != nullptr) v = __fadd_rn(v, a.res[o]);
  return v;
}

// BM x BN outputs per block, TM x TN per thread (TM, TN multiples of 4),
// VW floats per copy (4 or 1).
template <int BM, int BN, int TM, int TN, int VW>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
conv2d_igemm_kernel(const ConvArgs a) {
  constexpr int kThreads = (BM / TM) * (BN / TN);
  constexpr int BK = kBK;
  constexpr int KV = BK / VW;  // copies along k in one input row of a tile
  constexpr int NV = BN / VW;  // copies along C_out in one weight row
  constexpr int kASlots = BM * KV / kThreads;
  constexpr int kBSlots = BK * NV / kThreads;
  constexpr int AP = BK + 4;  // input row stride in shared memory
  static_assert(TM % 4 == 0 && TN % 4 == 0, "4-wide register groups");
  static_assert(kThreads % KV == 0 && kThreads % NV == 0, "loader layout");
  static_assert(BM * KV % kThreads == 0 && BK * NV % kThreads == 0,
                "loader slots");

  extern __shared__ __align__(16) float smem[];
  float(*As)[BM][AP] = reinterpret_cast<float(*)[BM][AP]>(smem);
  float(*Bs)[BK][BN] =
      reinterpret_cast<float(*)[BK][BN]>(smem + kStages * BM * AP);

  const int tid = threadIdx.x;
  const int M = a.N * a.H * a.W;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int p = a.K / 2;
  const int k_total = a.K * a.K * a.Cin;
  const int num_kt = (k_total + BK - 1) / BK;

  // Input copies: this thread's k lane and output pixels are fixed; its tap
  // (dy, dx) and channel ci advance by BK each tile.
  const int kv = tid % KV;
  int a_pix[kASlots], a_oh[kASlots], a_ow[kASlots];
#pragma unroll
  for (int s = 0; s < kASlots; ++s) {
    const int m = m0 + tid / KV + s * (kThreads / KV);
    a_pix[s] = m;
    a_ow[s] = m % a.W;
    a_oh[s] = m < M ? (m / a.W) % a.H : -(1 << 29);  // never inside the image
  }
  int ci = kv * VW, dy = 0, dx = 0;
  {
    const int tap = ci / a.Cin;
    ci -= tap * a.Cin;
    dy = tap / a.K;
    dx = tap - dy * a.K;
  }
  // Weight copies: this thread's C_out lane is fixed.
  const int nv = tid % NV;
  const int b_co = n0 + nv * VW;
  const bool b_co_ok = b_co < a.Cout;  // VW = 4: C_out % 4 == 0

  auto load_tile = [&](int stage, int kt) {
    const bool k_ok = dy < a.K;
#pragma unroll
    for (int s = 0; s < kASlots; ++s) {
      const int ih = a_oh[s] + dy - p;
      const int iw = a_ow[s] + dx - p;
      const bool ok = k_ok && ih >= 0 && ih < a.H && iw >= 0 && iw < a.W;
      const float* src =
          ok ? a.x + (size_t)(a_pix[s] + (dy - p) * a.W + (dx - p)) * a.Cin + ci
             : a.x;
      cp_async<VW>(&As[stage][tid / KV + s * (kThreads / KV)][kv * VW], src,
                   ok);
    }
#pragma unroll
    for (int s = 0; s < kBSlots; ++s) {
      const int kr = tid / NV + s * (kThreads / NV);
      const int k = kt * BK + kr;
      const bool ok = b_co_ok && k < k_total;
      const float* src = ok ? a.w + (size_t)k * a.Cout + b_co : a.w;
      cp_async<VW>(&Bs[stage][kr][nv * VW], src, ok);
    }
    ci += BK;
    while (ci >= a.Cin) {
      ci -= a.Cin;
      if (++dx == a.K) {
        dx = 0;
        ++dy;
      }
    }
  };

  // Register tile: rows ty*4 + i of each of TM/4 row groups, columns
  // tx*4 + j of each of TN/4 column groups (conflict-free float4 reads).
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  // kStages - 1 tiles in flight ahead of the one being multiplied; one
  // commit group per tile (empty past the end) keeps the count uniform.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < num_kt) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < num_kt; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed ...
    __syncthreads();  // ... for every thread, and tile kt - 1 is consumed
    const int next = kt + kStages - 1;
    if (next < num_kt) load_tile(next % kStages, next);
    cp_async_commit();
    const int st = kt % kStages;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float av[TM][4];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(
              &As[st][g * (BM * 4 / TM) + ty * 4 + i][kk]);
          av[g * 4 + i][0] = v.x;
          av[g * 4 + i][1] = v.y;
          av[g * 4 + i][2] = v.z;
          av[g * 4 + i][3] = v.w;
        }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float bv[TN];
#pragma unroll
        for (int g = 0; g < TN / 4; ++g) {
          const float4 v = *reinterpret_cast<const float4*>(
              &Bs[st][kk + q][g * (BN * 4 / TN) + tx * 4]);
          bv[g * 4 + 0] = v.x;
          bv[g * 4 + 1] = v.y;
          bv[g * 4 + 2] = v.z;
          bv[g * 4 + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(av[i][q], bv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i / 4) * (BM * 4 / TM) + ty * 4 + (i % 4);
    if (m >= M) continue;
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const int co = n0 + g * (BN * 4 / TN) + tx * 4;
      const size_t o = (size_t)m * a.Cout + co;
      if constexpr (VW == 4) {
        if (co >= a.Cout) continue;
        float4 v;
        v.x = epilogue(a, acc[i][g * 4 + 0], co + 0, o + 0);
        v.y = epilogue(a, acc[i][g * 4 + 1], co + 1, o + 1);
        v.z = epilogue(a, acc[i][g * 4 + 2], co + 2, o + 2);
        v.w = epilogue(a, acc[i][g * 4 + 3], co + 3, o + 3);
        *reinterpret_cast<float4*>(a.y + o) = v;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (co + j < a.Cout)
            a.y[o + j] = epilogue(a, acc[i][g * 4 + j], co + j, o + j);
      }
    }
  }
}

template <int BM, int BN, int TM, int TN>
int launch(const ConvArgs& a, int vw, cudaStream_t stream) {
  const long long M = (long long)a.N * a.H * a.W;
  const dim3 grid((unsigned)((M + BM - 1) / BM),
                  (unsigned)((a.Cout + BN - 1) / BN));
  const dim3 block((BM / TM) * (BN / TN));
  const int smem = kStages * (BM * (kBK + 4) + kBK * BN) * (int)sizeof(float);
  auto kernel = vw == 4 ? conv2d_igemm_kernel<BM, BN, TM, TN, 4>
                        : conv2d_igemm_kernel<BM, BN, TM, TN, 1>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, block, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return p == nullptr || ((uintptr_t)p & 15) == 0;
}

// The tile shapes: BM x BN outputs a block, TM x TN a thread. tile < 0
// picks the one whose busiest SM finishes first: ceil(blocks / SMs) * BM * BN
// outputs at the tile's rate. The rates are outputs * k per SM per unit
// time, relative, read from `chip_profile.py --tiles` at batch 24 (every SM
// busy) on an H100 80GB HBM3 at 700 W; 8x8 register tiles issue FMAs better
// than 4x4, small tiles balance small layers over the 132 SMs. (128x128 and
// 64x128 tiles were never faster there.) tile 0..2 forces one. Which is
// chosen never changes the order of an output's sum, so never its bits.
struct Tile {
  int bm, bn, rate;
};
constexpr int kNumTiles = 3;
constexpr Tile kTiles[kNumTiles] = {
    {128, 64, 160}, {64, 64, 131}, {32, 32, 125}};

int pick_tile(long long M, int Cout) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int best = 0;
  double best_t = 0.0;
  for (int t = 0; t < kNumTiles; ++t) {
    const Tile& c = kTiles[t];
    const long long blocks =
        ((M + c.bm - 1) / c.bm) * ((Cout + c.bn - 1) / c.bn);
    const double time =
        (double)((blocks + sms - 1) / sms) * c.bm * c.bn / c.rate;
    if (t == 0 || time < best_t) {
      best = t;
      best_t = time;
    }
  }
  return best;
}

}  // namespace

extern "C" int fg_conv2d_nhwc(const void* x, const void* w, const void* bias,
                              const void* res, void* y, int N, int H, int Wd,
                              int Cin, int Cout, int K, int leaky,
                              float neg_slope, int tile, void* stream) {
  if (K < 1 || K % 2 == 0 || N < 1 || H < 1 || Wd < 1 || Cin < 1 || Cout < 1 ||
      tile >= kNumTiles)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)N * H * Wd;
  if (M + 128 > 0x7fffffffLL || (long long)K * K * Cin > 0x7fffffffLL ||
      Cout > 65535 * 32)
    return (int)cudaErrorInvalidValue;
  const ConvArgs a{(const float*)x, (const float*)w, (const float*)bias,
                   (const float*)res, (float*)y, N, H, Wd, Cin, Cout, K,
                   leaky, neg_slope};
  const int vw = (Cin % 4 == 0 && Cout % 4 == 0 && aligned16(x) &&
                  aligned16(w) && aligned16(bias) && aligned16(res) &&
                  aligned16(y))
                     ? 4
                     : 1;
  if (tile < 0) tile = pick_tile(M, Cout);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (tile) {  // kTiles
    case 0: return launch<128, 64, 8, 8>(a, vw, s);
    case 1: return launch<64, 64, 4, 4>(a, vw, s);
    default: return launch<32, 32, 4, 4>(a, vw, s);
  }
}
