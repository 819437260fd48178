// Stride-1 "same" KxK convolution over NHWC in bfloat16 on the tensor cores
// of Hopper (sm_90a), float32 accumulation, with bias, LeakyReLU and a
// residual add fused into the epilogue.
//
// Replaces the bf16 route (its default compute_dtype) of the Pallas TPU
// kernel flashgmm_tpu/ops/pallas_conv.py::_conv_kernel, which the codec's
// transforms g_a, h_a and g_s take: there the kernel is a chain of bf16 MXU
// matmuls with an f32 accumulator; here the MXU's counterpart is the tensor
// core, driven by wgmma with bf16 operands and f32 sums.
//
// The GEMM: M = output pixels, N = C_out, and the reduction runs over
// k = (c_in block of 64, dy, dx, c_in). The design, for Hopper:
// - Persistent, warp-specialised blocks: one block of 3 warpgroups on each
//   SM walks the output tiles (n-tile fastest, then along a row of tiles,
//   so consecutive tiles share weights and input rows in L2). One thread of
//   the last warpgroup (the producer, which gives its registers to the
//   others by setmaxnreg) keeps TMA loads in flight into two rings of
//   shared-memory stages, signalled by mbarriers; two consumer warpgroups
//   run wgmma.mma_async on the stages that have landed.
// - A tile is a spatial block of one image: 8 rows x 16 columns of output
//   pixels by 192 output channels (the transforms' latents, 384x256 down to
//   24x16, divide into it). Consumer g owns columns 8g..8g+7: a 64-pixel by
//   192-channel accumulator, m64n192k16, 96 f32 registers a thread. C_out
//   192 and 1536 tile with no waste; for other multiples of 8 the weights'
//   rows past C_out load as zeros and the stores clip those columns.
// - The im2col is done by the copy engine, once a 64-channel block: the
//   tile's input halo, (8 + K - 1) x (16 + K - 1) pixels, lands by TMA as 8
//   planes of 8 channels, each plane [pixel][16 bytes]. Pixels outside the
//   image come back from TMA as zeros: that is the "same" padding, with no
//   bounds check in any thread; channels past C_in are zeros too. In that
//   layout the A operand of tap (dy, dx) is the halo read from pixel
//   (dy, dx) on: 8 pixels of a row are one 8 x 16-byte core matrix (no
//   swizzle), the next row is halo_w * 16 bytes on (the descriptor's stride
//   offset), the next 8 channels one plane on (its leading offset). So the
//   K*K taps of a channel block read one halo from shared memory, and the
//   input leaves L2 once a channel block instead of once a tap.
// - The weights come packed (the wrapper packs them once) as [K*K, C_out,
//   C_in], C_in contiguous: the B operand of (tap, channel block) is one TMA
//   box of 64 channels x 192 output channels, 128-byte swizzled, with
//   channels past C_in and rows past C_out zero-filled within each tap.
// - The epilogue works on the f32 accumulator in the TPU kernel's order:
//   + the f32 bias (staged in shared memory during the tile), LeakyReLU
//   with the given slope, + the residual (bf16 or f32, read at its own
//   type), then one rounding to the output type. The residual has the
//   output's type (the wrapper sees to that) and is brought by TMA into
//   the consumer's staging buffer while the tile's last channel block is
//   multiplied; the result replaces it there (128-byte swizzled,
//   conflict-free) and leaves by TMA stores, which clip the pixels and
//   channels past the tensor's edge. Meanwhile the producer is already
//   loading the next tile.
//
// The bound on the card: at the transforms' shapes (C_in 192, C_out 192 or
// 1536, K = 3) a conv does 2 * 1728 flops for every output, far above the
// card's ~295 flops a byte of device memory, so the bound is
// 2 * M * C_out * K*K*C_in flops at 989 TFLOP/s dense bf16. The kernel
// reaches 60-70 % of it at those shapes; what holds it there is not known
// yet (PERF.md sections 6 and 7). The L2 traffic of the operands is 120
// flops a byte (9 weight boxes of 24 KB and one 23 KB halo feed 28 MFLOP a
// tile and channel block). ptxas gives every thread the 168 registers of a
// 384-thread block; setmaxnreg moves the physical registers only.

#include <cstdint>
#include <cstring>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mbarrier.cuh"

namespace {

constexpr int kTileH = 8, kTileW = 16;  // output pixels a tile
constexpr int kBN = 192;                // output channels a tile
constexpr int kBK = 64;        // input channels a block (one 128-byte row)
constexpr int kConsumers = 2;  // consumer warpgroups, 8 x 8 pixels each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBBytes = kBN * kBK * 2;      // one weight box
constexpr int kChunkBytes = 64 * 128;       // one output box: 64 px x 128 B
constexpr int kOutBytes = 3 * kChunkBytes;  // a consumer's staging
constexpr int kAStages = 2;  // the halo ring (two fit at every K up to 7)
constexpr int kMaxB = 6;     // the weight ring, at most
constexpr int kBars = 2 * (kAStages + kMaxB) + kConsumers;
constexpr int kSmemLimit = 232448;          // dynamic shared memory a block
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

struct Params {
  const float* bias;
  int residual, leaky;
  float slope;
  int Cout, K;
  int tiles_h, tiles_w, tiles_n, num_tiles, cblocks;
  int halo_w, plane_bytes, a_box_bytes;  // the input halo: 8 planes
  int b_stages;
  uint32_t out_off, bias_off, a_off, bar_off;  // offsets in shared memory
};

using namespace fg;  // smem_u32, mbar_* (mbarrier.cuh)

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* m,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* m,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* m,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(m)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// The staging may be written again: earlier stores have read it.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Shared-memory writes of the generic proxy made visible to TMA (the async
// proxy) before a store reads them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier of one warpgroup (id 1 + its index; 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of the accumulator across the
// asynchronous wgmma instructions that own it.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), layout (0 none, 1 128-byte swizzle).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (layout << 62);
}

// d += a * b on one m64n192k16 tile of the warpgroup (96 f32 a thread);
// scale_d == 0 makes it d = a * b.
__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Shared-memory accesses of the epilogue. No "memory" clobber, so the
// compiler may batch them and the loads around them; volatile keeps them in
// order with the barriers and fences, which are volatile too.
__device__ __forceinline__ void st_shared(uint32_t a, float v0, float v1) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(a), "f"(v0),
               "f"(v1));
}

__device__ __forceinline__ void st_shared(uint32_t a, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v));
}

__device__ __forceinline__ void st_shared(uint32_t a, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(a), "f"(v));
}

__device__ __forceinline__ float2 ld_shared_f2(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(a));
  return v;
}

__device__ __forceinline__ uint32_t ld_shared_b32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ float2 bf16x2_to_f2(uint32_t v) {
  __nv_bfloat162 b;
  memcpy(&b, &v, 4);
  return __bfloat1622float2(b);
}

__device__ __forceinline__ uint32_t f2_to_bf16x2(float v0, float v1) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(v0, v1);
  uint32_t v;
  memcpy(&v, &b, 4);
  return v;
}

// One output tile of the persistent walk: image n, first row h0, first
// column w0, n-tile nt (fastest), so consecutive tiles share input rows.
struct Tile {
  int n, h0, w0, nt;
};

__device__ __forceinline__ Tile tile_at(const Params& p, int t) {
  Tile r;
  r.nt = t % p.tiles_n;
  t /= p.tiles_n;
  r.w0 = (t % p.tiles_w) * kTileW;
  t /= p.tiles_w;
  r.h0 = (t % p.tiles_h) * kTileH;
  r.n = t / p.tiles_h;
  return r;
}

template <bool kF32Out>
__global__ void __launch_bounds__(kThreads, 1)
    conv2d_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                             const __grid_constant__ CUtensorMap tm_w,
                             const __grid_constant__ CUtensorMap tm_y,
                             const __grid_constant__ CUtensorMap tm_r,
                             const Params p) {
  constexpr int kChunkCh = kF32Out ? 32 : 64;  // channels of an output box
  constexpr int kChunks = kBN / kChunkCh;       // 6 or 3
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // 1024-aligned
  const uint32_t bars = base + p.bar_off;
  const auto full_b = [&](int i) { return bars + 8 * i; };
  const auto empty_b = [&](int i) { return bars + 8 * (kMaxB + i); };
  const auto full_a = [&](int i) { return bars + 8 * (2 * kMaxB + i); };
  const auto empty_a = [&](int i) {
    return bars + 8 * (2 * kMaxB + kAStages + i);
  };
  const auto res_full = [&](int g) {
    return bars + 8 * (2 * (kMaxB + kAStages) + g);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.b_stages; ++i) {
      mbar_init(full_b(i), 1);
      mbar_init(empty_b(i), kConsumers * 128);
    }
    for (int i = 0; i < kAStages; ++i) {
      mbar_init(full_a(i), 1);
      mbar_init(empty_a(i), kConsumers * 128);
    }
    for (int g = 0; g < kConsumers; ++g) mbar_init(res_full(g), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  const int kk = p.K * p.K;

  if (wg == kConsumers) {
    // The producer: one thread issues every operand load, in the
    // consumers' order.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      const int pad = p.K / 2;
      int as = 0, bs = 0;
      uint32_t aph = 0, bph = 0;
      for (int t = blockIdx.x; t < p.num_tiles; t += gridDim.x) {
        const Tile tl = tile_at(p, t);
        for (int cb = 0; cb < p.cblocks; ++cb) {
          // the tile's input halo of this channel block: 8 planes of 8
          // channels, zeros outside the image and past C_in
          mbar_wait(empty_a(as), aph ^ 1);
          mbar_expect_tx(full_a(as), 8 * p.a_box_bytes);
          const uint32_t dst = base + p.a_off + as * 8 * p.plane_bytes;
          for (int k = 0; k < 8; ++k)
            tma_load_4d(dst + k * p.plane_bytes, &tm_x, full_a(as),
                        cb * kBK + 8 * k, tl.w0 - pad, tl.h0 - pad, tl.n);
          if (++as == kAStages) {
            as = 0;
            aph ^= 1;
          }
          for (int tap = 0; tap < kk; ++tap) {
            mbar_wait(empty_b(bs), bph ^ 1);
            mbar_expect_tx(full_b(bs), kBBytes);
            tma_load_3d(base + bs * kBBytes, &tm_w, full_b(bs), cb * kBK,
                        tl.nt * kBN, tap);
            if (++bs == p.b_stages) {
              bs = 0;
              bph ^= 1;
            }
          }
        }
      }
    }
  } else {
    // A consumer warpgroup: columns 8 * wg .. 8 * wg + 7 of each tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x / 32) % 4;
    const bool leader = threadIdx.x % 128 == 0;
    const uint32_t lbo_a = p.plane_bytes;  // the next 8 channels
    const uint32_t sbo_a = p.halo_w * 16;  // the next row of 8 pixels
    const uint32_t stage = base + p.out_off + wg * kOutBytes;
    const uint32_t bias_s = base + p.bias_off + wg * kBN * 4;  // the n-tile's
    float acc[kBN / 2];
    int as = 0, bs = 0;
    uint32_t aph = 0, bph = 0, res_ph = 0;
    // the residual for a round of 3 output boxes, into the staging
    const auto load_residual = [&](const Tile& tl, int round) {
      mbar_expect_tx(res_full(wg), 3 * kChunkBytes);
      for (int q = 3 * round; q < 3 * round + 3; ++q)
        tma_load_4d(stage + (q % 3) * kChunkBytes, &tm_r, res_full(wg),
                    tl.nt * kBN + q * kChunkCh, tl.w0 + 8 * wg, tl.h0, tl.n);
    };
    for (int t = blockIdx.x; t < p.num_tiles; t += gridDim.x) {
      const Tile tl = tile_at(p, t);
      // The n-tile's bias into shared memory (the last tile's epilogue has
      // read it: its final warpgroup barrier came after), zeros past C_out.
      if (p.bias != nullptr) {
        for (int c = threadIdx.x % 128; c < kBN; c += 128) {
          const int co = tl.nt * kBN + c;
          st_shared(bias_s + 4 * c, co < p.Cout ? __ldg(p.bias + co) : 0.0f);
        }
      }
      // Each k-step's group of wgmmas stays in flight while the next one is
      // issued; its stages are released once it has completed.
      int prev_b = -1, prev_a = -1;
      for (int cb = 0; cb < p.cblocks; ++cb) {
        if (cb == p.cblocks - 1 && p.residual && leader) {
          bulk_wait_read();  // the last tile's stores have left the staging
          load_residual(tl, 0);
        }
        mbar_wait(full_a(as), aph);
        const uint32_t a_stage = base + p.a_off + as * 8 * p.plane_bytes;
        int dy = 0, dx = 0;
        for (int tap = 0; tap < kk; ++tap) {
          mbar_wait(full_b(bs), bph);
          const uint32_t a0 =
              a_stage + (dy * p.halo_w + 8 * wg + dx) * 16;
          const uint32_t b0 = base + bs * kBBytes;
          fence_acc(acc);
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < kBK / 16; ++s)
            wgmma_n192(acc, desc(a0 + 2 * s * lbo_a, lbo_a, sbo_a, 0),
                       desc(b0 + 32 * s, 16, 1024, 1), (cb | tap | s) != 0);
          wgmma_commit();
          fence_acc(acc);
          wgmma_wait<1>();
          if (prev_b >= 0) mbar_arrive(empty_b(prev_b));
          if (prev_a >= 0) mbar_arrive(empty_a(prev_a));
          prev_b = bs;
          prev_a = tap == kk - 1 ? as : -1;
          if (++bs == p.b_stages) {
            bs = 0;
            bph ^= 1;
          }
          if (++dx == p.K) {
            dx = 0;
            ++dy;
          }
        }
        if (++as == kAStages) {
          as = 0;
          aph ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (prev_b >= 0) mbar_arrive(empty_b(prev_b));
      if (prev_a >= 0) mbar_arrive(empty_a(prev_a));

      // Epilogue. Accumulator layout of m64n192: thread (warp, lane) holds
      // rows m = 16 * warp + lane / 4 (+ 8) of the consumer's 64 pixels,
      // i.e. tile row 2 * warp (+ 1), column 8 * wg + lane / 4; columns
      // 8j + 2 (lane % 4) (+ 1) in registers 4j (+ 1), and 4j + 2 (+ 3) for
      // row m + 8. A box row m holds 128 bytes whose 16-byte chunks sit
      // XOR-swizzled by m % 8 = lane / 4, as TMA's 128-byte swizzle places
      // them; a thread's pair of columns is 4 (bf16) or 8 (f32) bytes of
      // chunk 8j / 8 % 8 (bf16) or (8j + 2t) / 4 % 8 (f32).
      const int c0 = tl.nt * kBN;
      const int t4 = lane % 4;
      const uint32_t row_lo = stage + (16 * warp + lane / 4) * 128;
      const int sw = kF32Out ? (lane / 4) ^ (t4 >> 1) : lane / 4;
      const uint32_t in_chunk = kF32Out ? (t4 & 1) * 8 : t4 * 4;
      for (int round = 0; 3 * round < kChunks; ++round) {
        if (leader) {
          if (round > 0 || !p.residual) bulk_wait_read();
          if (round > 0 && p.residual) load_residual(tl, round);
        }
        warpgroup_sync(1 + wg);
        if (p.residual) {
          mbar_wait(res_full(wg), res_ph);
          res_ph ^= 1;
        }
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          constexpr int kJ = kChunkCh / 8;  // n8 blocks of an output box
          if (j / kJ / 3 != round) continue;
          const int co = c0 + 8 * j + 2 * t4;
          float2 bias = make_float2(0.0f, 0.0f);
          if (p.bias != nullptr) bias = ld_shared_f2(bias_s + 4 * (co - c0));
          const int chunk = kF32Out ? 2 * (j % 4) : j % 8;
          const uint32_t col =
              (j / kJ % 3) * kChunkBytes + ((chunk ^ sw) << 4) + in_chunk;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const uint32_t at = row_lo + half * 8 * 128 + col;
            float v0 = acc[4 * j + 2 * half];
            float v1 = acc[4 * j + 2 * half + 1];
            if (p.bias != nullptr) {
              v0 = __fadd_rn(v0, bias.x);
              v1 = __fadd_rn(v1, bias.y);
            }
            if (p.leaky) {
              v0 = v0 >= 0.0f ? v0 : __fmul_rn(p.slope, v0);
              v1 = v1 >= 0.0f ? v1 : __fmul_rn(p.slope, v1);
            }
            if (p.residual) {
              const float2 r = kF32Out ? ld_shared_f2(at)
                                       : bf16x2_to_f2(ld_shared_b32(at));
              v0 = __fadd_rn(v0, r.x);
              v1 = __fadd_rn(v1, r.y);
            }
            if (kF32Out)
              st_shared(at, v0, v1);
            else
              st_shared(at, f2_to_bf16x2(v0, v1));
          }
        }
        fence_proxy_async();
        warpgroup_sync(1 + wg);
        if (leader) {
          for (int q = 3 * round; q < 3 * round + 3; ++q)
            tma_store_4d(&tm_y, stage + (q % 3) * kChunkBytes,
                         c0 + q * kChunkCh, tl.w0 + 8 * wg, tl.h0, tl.n);
          bulk_commit();
        }
      }
    }
    if (leader) bulk_wait_all();
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (the library
// links no libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// A tiled tensor map of `rank` dimensions (innermost first), zeros outside.
bool encode(CUtensorMap* m, CUtensorMapDataType type, cuuint32_t rank,
            const void* ptr, const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const EncodeTiled fn = encode_tiled();
  return fn != nullptr &&
         fn(m, type, rank, const_cast<void*>(ptr), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Shared memory: the weight ring, the consumers' staging, the two halo
// stages and the barriers, the weight ring as deep as fits. Returns the
// bytes to ask for (0 if nothing fits).
int plan(Params& p) {
  const int halo_h = kTileH + p.K - 1;
  p.halo_w = kTileW + p.K - 1;
  const int pix = halo_h * p.halo_w;
  p.a_box_bytes = pix * 16;
  p.plane_bytes = (pix + 7) / 8 * 128;  // planes 128-byte aligned for TMA
  const int a_bytes = kAStages * 8 * p.plane_bytes;
  for (int b = kMaxB; b >= 3; --b) {
    const int bytes = b * kBBytes + kConsumers * (kOutBytes + 4 * kBN) +
                      a_bytes + 8 * kBars + 1024;  // + alignment slack
    if (bytes <= kSmemLimit) {
      p.b_stages = b;
      p.out_off = b * kBBytes;
      p.bias_off = p.out_off + kConsumers * kOutBytes;
      p.a_off = p.bias_off + kConsumers * 4 * kBN;
      p.bar_off = p.a_off + a_bytes;
      return bytes;
    }
  }
  return 0;
}

bool aligned(const void* p, uintptr_t bytes) {
  return p == nullptr || ((uintptr_t)p % bytes) == 0;
}

}  // namespace

// x [N, H, W, Cin] bf16; w [K*K, Cout, Cin] bf16 (the packed weights: tap
// dy * K + dx, output channel, input channel); bias [Cout] f32 or null; y
// [N, H, W, Cout] (f32 when out_f32, else bf16); res [N, H, W, Cout] of y's
// type, or null. Returns a cudaError_t.
extern "C" int fg_conv2d_nhwc_bf16(const void* x, const void* w,
                                   const void* bias, const void* res,
                                   void* y, int out_f32, int N,
                                   int H, int Wd, int Cin, int Cout, int K,
                                   int leaky, float neg_slope, void* stream) {
  if (K < 1 || K > 7 || K % 2 == 0 || N < 1 || H < 1 || Wd < 1 || Cin < 8 ||
      Cout < 8 || Cin % 8 != 0 || Cout % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned(x, 16) || !aligned(w, 16) || !aligned(y, 16) ||
      !aligned(bias, 8) || !aligned(res, 16))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.bias = static_cast<const float*>(bias);
  p.residual = res != nullptr;
  p.leaky = leaky;
  p.slope = neg_slope;
  p.Cout = Cout;
  p.K = K;
  p.tiles_h = (H + kTileH - 1) / kTileH;
  p.tiles_w = (Wd + kTileW - 1) / kTileW;
  p.tiles_n = (Cout + kBN - 1) / kBN;
  const long long tiles = (long long)N * p.tiles_h * p.tiles_w * p.tiles_n;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.num_tiles = (int)tiles;
  p.cblocks = (Cin + kBK - 1) / kBK;
  const int smem = plan(p);
  if (smem == 0) return (int)cudaErrorInvalidValue;

  // x as [N, H, W, Cin] (innermost first: Cin, W, H, N), boxes of 8
  // channels over the halo; the packed weights as [K*K, Cout, Cin], boxes
  // of 64 x 192; y (and a residual of its type) as [N, H, W, Cout], boxes
  // of 128 bytes of channels over 8 x 8 pixels.
  const cuuint64_t es = out_f32 ? 4 : 2;
  const cuuint64_t dx[4] = {(cuuint64_t)Cin, (cuuint64_t)Wd, (cuuint64_t)H,
                            (cuuint64_t)N};
  const cuuint64_t sx[3] = {2ull * Cin, 2ull * Cin * Wd, 2ull * Cin * Wd * H};
  const cuuint32_t bx[4] = {8, (cuuint32_t)p.halo_w,
                            (cuuint32_t)(kTileH + K - 1), 1};
  const cuuint64_t dw[3] = {(cuuint64_t)Cin, (cuuint64_t)Cout,
                            (cuuint64_t)(K * K)};
  const cuuint64_t sw[2] = {2ull * Cin, 2ull * Cin * Cout};
  const cuuint32_t bw[3] = {kBK, kBN, 1};
  const cuuint64_t dy[4] = {(cuuint64_t)Cout, (cuuint64_t)Wd, (cuuint64_t)H,
                            (cuuint64_t)N};
  const cuuint64_t sy[3] = {es * Cout, es * Cout * Wd, es * Cout * Wd * H};
  const cuuint32_t by[4] = {(cuuint32_t)(128 / es), 8, 8, 1};
  const CUtensorMapDataType ty = out_f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap mx, mw, my, mr;
  if (!encode(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x, dx, sx, bx,
              CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode(&mw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, w, dw, sw, bw,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&my, ty, 4, y, dy, sy, by, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&mr, ty, 4, p.residual ? res : y, dy, sy, by,
              CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;

  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const auto kernel = out_f32 ? conv2d_bf16_wgmma_kernel<true>
                             : conv2d_bf16_wgmma_kernel<false>;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (int)(tiles < sms ? tiles : sms);  // persistent blocks
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(mx, mw, my, mr, p);
  return (int)cudaGetLastError();
}
