// Stride-1 "same" KxK convolution over NHWC in bfloat16 on the tensor cores
// of Hopper (sm_90a), float32 accumulation, with bias, LeakyReLU and a
// residual add fused into the epilogue.
//
// Replaces the bf16 route (its default compute_dtype) of the Pallas TPU
// kernel flashgmm_tpu/ops/pallas_conv.py::_conv_kernel, which the codec's
// transforms g_a, h_a and g_s take: there the kernel is a chain of bf16 MXU
// matmuls with an f32 accumulator; here the MXU's counterpart is the tensor
// core, driven by mma.sync.m16n8k16 with bf16 operands and f32 sums.
//
// The GEMM: M = output pixels (N*H*W), N = C_out, and the reduction runs over
// k = (dy, dx, c_in), the row index of the HWIO weights seen as a
// [K*K*C_in, C_out] matrix. A block of 8 warps computes a 128 x 192 tile of
// outputs (the transforms' C_out of 192 and 1536 fill it; other multiples of
// 8 run with the columns past C_out zero-filled and masked); each warp a
// 64 x 48 sub-tile, as 4 x 6 m16n8 accumulator tiles in registers.
// Tiles of 32 k's are staged in shared memory by cp.async, kStages deep, and
// read into the tensor cores' fragments with ldmatrix (the weights with
// .trans, so their C_out-contiguous rows become the column-major B operand).
// The input tile is gathered straight from the NHWC image (im2col on the
// fly): with C_in a multiple of 8 every 16-byte copy of 8 channels lies
// inside one tap, and taps outside the image are zero-filled by the copy.
// Rows of both tiles are padded by 16 bytes so ldmatrix's 8 row addresses
// fall in 8 different bank groups.
//
// The epilogue works on the f32 accumulator in the TPU kernel's order: + the
// f32 bias, LeakyReLU with the given slope, + the residual (bf16 or f32, read
// as f32), then one rounding to the output type (bf16, or f32).
//
// What bounds it on the card: tensor-core issue. At the transforms' shapes
// (C_in 192, C_out 192 or 1536, K = 3) a conv does ~2 * 1728 flops for every
// output and reads each input value once per tap from L2, far above the
// card's ~295 flops a byte of device memory, so the bound is 2*M*C_out*k flops
// at 989 TFLOP/s dense bf16. mma.sync reaches only part of that rate on
// Hopper (wgmma, TMA and a persistent warp-specialised design are the way
// to the rest).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;  // output pixels a block
constexpr int kBN = 192;  // output channels a block
constexpr int kBK = 32;   // reduction depth of one staged tile
constexpr int kStages = 4;
constexpr int kWarpsM = 2, kWarpsN = 4;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kAPitch = kBK + 8;  // bf16 a row of the input tile (80 bytes)

struct ConvArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;
  const float* bias;
  const void* res;
  void* y;
  int N, H, W, Cin, Cout, K, leaky, res_f32, out_f32;
  float neg_slope;
};

// cp.async of 16 bytes; with valid == false nothing is read and the
// destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// d += a * b on one m16n8k16 tile: bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float epilogue(const ConvArgs& a, float v, int co,
                                          float r) {
  if (a.bias != nullptr) v = __fadd_rn(v, a.bias[co]);
  if (a.leaky) v = v >= 0.0f ? v : __fmul_rn(a.neg_slope, v);
  if (a.res != nullptr) v = __fadd_rn(v, r);
  return v;
}

__global__ void __launch_bounds__(kThreads)
conv2d_bf16_mma_kernel(const ConvArgs a) {
  constexpr int WM = kBM / kWarpsM;  // 64 rows a warp
  constexpr int WN = kBN / kWarpsN;  // 48 columns a warp
  constexpr int MT = WM / 16;        // m16 tiles a warp
  constexpr int NT = WN / 8;         // n8 tiles a warp
  constexpr int BPitch = kBN + 8;    // bf16 a row of the weight tile
  constexpr int kAChunks = kBM * kBK / 8 / kThreads;  // 16-byte copies
  constexpr int kBRow = kBN / 8;
  constexpr int kBChunks = kBK * kBRow / kThreads;
  static_assert(NT % 2 == 0, "one ldmatrix.x4.trans loads two n8 tiles");
  static_assert(kThreads % (kBK / 8) == 0, "input loader layout");
  static_assert(kBK * kBRow % kThreads == 0, "weight loader layout");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16(*As)[kBM][kAPitch] =
      reinterpret_cast<__nv_bfloat16(*)[kBM][kAPitch]>(smem_raw);
  __nv_bfloat16(*Bs)[kBK][BPitch] =
      reinterpret_cast<__nv_bfloat16(*)[kBK][BPitch]>(
          smem_raw + sizeof(__nv_bfloat16) * kStages * kBM * kAPitch);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp / kWarpsN;
  const int wn = warp % kWarpsN;
  const int n_blocks = (a.Cout + kBN - 1) / kBN;
  // consecutive blocks share one row of input pixels (kept in L2)
  const int m0 = (int)(blockIdx.x / n_blocks) * kBM;
  const int n0 = (int)(blockIdx.x % n_blocks) * kBN;
  const int M = a.N * a.H * a.W;
  const int p = a.K / 2;
  const int k_total = a.K * a.K * a.Cin;
  const int num_kt = (k_total + kBK - 1) / kBK;

  // Input copies: this thread's 8-channel column kc of the tile and its
  // output pixels are fixed; its tap (dy, dx) and channel ci advance by kBK
  // each tile (a copy never straddles two taps: C_in % 8 == 0).
  const int kc = tid % (kBK / 8);
  int a_pix[kAChunks], a_oh[kAChunks], a_ow[kAChunks];
#pragma unroll
  for (int s = 0; s < kAChunks; ++s) {
    const int m = m0 + tid / (kBK / 8) + s * (kThreads / (kBK / 8));
    a_pix[s] = m;
    a_ow[s] = m % a.W;
    a_oh[s] = m < M ? (m / a.W) % a.H : -(1 << 29);  // never inside the image
  }
  int ci = kc * 8, dy = 0, dx = 0;
  {
    const int tap = ci / a.Cin;
    ci -= tap * a.Cin;
    dy = tap / a.K;
    dx = tap - dy * a.K;
  }
  // Weight copies: fixed (row, column) slots of the tile.
  int b_kr[kBChunks], b_co[kBChunks];
#pragma unroll
  for (int s = 0; s < kBChunks; ++s) {
    const int c = tid + s * kThreads;
    b_kr[s] = c / kBRow;
    b_co[s] = n0 + (c % kBRow) * 8;
  }

  auto load_tile = [&](int stage, int kt) {
    const bool k_ok = dy < a.K;
#pragma unroll
    for (int s = 0; s < kAChunks; ++s) {
      const int ih = a_oh[s] + dy - p;
      const int iw = a_ow[s] + dx - p;
      const bool ok = k_ok && ih >= 0 && ih < a.H && iw >= 0 && iw < a.W;
      const __nv_bfloat16* src =
          ok ? a.x + (size_t)(a_pix[s] + (dy - p) * a.W + (dx - p)) * a.Cin + ci
             : a.x;
      const int row = tid / (kBK / 8) + s * (kThreads / (kBK / 8));
      cp_async16(&As[stage][row][kc * 8], src, ok);
    }
#pragma unroll
    for (int s = 0; s < kBChunks; ++s) {
      const int k = kt * kBK + b_kr[s];
      const bool ok = k < k_total && b_co[s] < a.Cout;
      const __nv_bfloat16* src = ok ? a.w + (size_t)k * a.Cout + b_co[s] : a.w;
      cp_async16(&Bs[stage][b_kr[s]][b_co[s] - n0], src, ok);
    }
    ci += kBK;
    while (ci >= a.Cin) {
      ci -= a.Cin;
      if (++dx == a.K) {
        dx = 0;
        ++dy;
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

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
    for (int kk = 0; kk < kBK; kk += 16) {
      // A fragments: lanes 0-15 address rows 0-15 at k 0, lanes 16-31 the
      // same rows at k 8; registers 0-3 are a0-a3 of the m16k16 operand.
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], &As[st][wm * WM + i * 16 + (lane & 15)]
                               [kk + (lane >> 4) * 8]);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        // B fragments of two n8 tiles: lanes 0-15 address k rows 0-15 of
        // columns 0-7, lanes 16-31 the same rows of columns 8-15; .trans
        // hands each thread its k pair of one column.
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, &Bs[st][kk + (lane & 15)]
                                 [wn * WN + j * 8 + (lane >> 4) * 8]);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][j], af[i], bf[0], bf[1]);
          mma_bf16(acc[i][j + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // Accumulator layout of m16n8: thread (g = lane / 4, t = lane % 4) holds
  // rows g and g + 8, columns 2t and 2t + 1.
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * WM + i * 16 + g + half * 8;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int co = n0 + wn * WN + j * 8 + 2 * t;
        if (co >= a.Cout) continue;  // C_out % 8 == 0: co + 1 < C_out too
        const size_t o = (size_t)m * a.Cout + co;
        float r0 = 0.0f, r1 = 0.0f;
        if (a.res != nullptr) {
          if (a.res_f32) {
            const float2 r = *reinterpret_cast<const float2*>(
                static_cast<const float*>(a.res) + o);
            r0 = r.x;
            r1 = r.y;
          } else {
            const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(
                static_cast<const __nv_bfloat16*>(a.res) + o);
            r0 = __low2float(r);
            r1 = __high2float(r);
          }
        }
        const float v0 = epilogue(a, acc[i][j][half * 2 + 0], co, r0);
        const float v1 = epilogue(a, acc[i][j][half * 2 + 1], co + 1, r1);
        if (a.out_f32) {
          *reinterpret_cast<float2*>(static_cast<float*>(a.y) + o) =
              make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(a.y) + o) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return p == nullptr || ((uintptr_t)p % bytes) == 0;
}

}  // namespace

// x [N, H, W, Cin] bf16, w [K, K, Cin, Cout] bf16 (HWIO), bias [Cout] f32 or
// null, res [N, H, W, Cout] (f32 when res_f32, else bf16) or null, y
// [N, H, W, Cout] (f32 when out_f32, else bf16). Returns a cudaError_t.
extern "C" int fg_conv2d_nhwc_bf16(const void* x, const void* w,
                                   const void* bias, const void* res,
                                   int res_f32, void* y, int out_f32, int N,
                                   int H, int Wd, int Cin, int Cout, int K,
                                   int leaky, float neg_slope, void* stream) {
  if (K < 1 || K > 7 || K % 2 == 0 || N < 1 || H < 1 || Wd < 1 || Cin < 8 ||
      Cout < 8 || Cin % 8 != 0 || Cout % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)N * H * Wd;
  if (M + kBM > 0x7fffffffLL || (long long)K * K * Cin > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (!aligned(x, 16) || !aligned(w, 16) || !aligned(bias, 4) ||
      !aligned(res, 8) || !aligned(y, 8))
    return (int)cudaErrorInvalidValue;
  const ConvArgs a{(const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
                   (const float*)bias, res, y, N, H, Wd, Cin, Cout, K, leaky,
                   res_f32, out_f32, neg_slope};
  const long long blocks = ((M + kBM - 1) / kBM) * ((Cout + kBN - 1) / kBN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(__nv_bfloat16) * kStages *
                   (kBM * kAPitch + kBK * (kBN + 8));
  const cudaError_t e = cudaFuncSetAttribute(
      conv2d_bf16_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  conv2d_bf16_mma_kernel<<<(unsigned)blocks, kThreads, smem,
                           (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
