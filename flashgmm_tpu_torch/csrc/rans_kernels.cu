// Interleaved 32-bit rANS encode and decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels flashgmm_tpu/ans/pallas_coder.py::
// _encode_kernel and ::_decode_kernel. Same math as the plain versions in
// flashgmm_tpu_torch/ans/interleaved.py: W lanes, symbol i at (step i / W,
// lane i % W), state in [2^16, 2^32), 16-bit probabilities, at most one u16
// word per lane and step. The encoder over GMM parameters (GmmBounds below)
// also takes the place, on the y passes, of the plain-XLA
// flashgmm_tpu/ans/gaussian_cdf.py:150 (gmm_guarded_bounds).
//
// Plain C interface (built by flashgmm_tpu_torch/_build.py with nvcc into one
// shared library, loaded with ctypes). Every entry launches on the caller's
// stream and returns cudaGetLastError() after the launch.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "gmm_entry.cuh"
#include "mbarrier.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t kRansL = 1u << 16;

// Encode: rans_encode_kernel<Src> walks t = T-1 ... 0. The lanes are cut
// into slabs of 32, one CTA a slab (W = 4096 gives 128 CTAs, one an SM);
// any W is taken, the last slab may be short. A CTA is one chain warp and 16
// producer warps around two rings in shared memory:
//   - inputs: producer warp p owns step p of every chunk of 16 steps. It
//     stages that step's inputs for its slab with cp.async (16-byte copies
//     where the segment is aligned, else 4-byte ones) two chunks ahead of
//     the chunk it works on, walking from the last chunk to the first; each
//     chunk is one cp.async group, completed by cp.async.wait_group, and a
//     warp reads only what it staged itself;
//   - records: for each symbol of its step the producer writes a 16-byte
//     record (m, start, freq, shifts) into a ring of 4 chunks, completed on
//     mbarriers (full: 512 producer arrivals; empty: the chain's 32);
//   - the chain warp, one lane a lane of the slab, loads a chunk's records
//     into registers, hands the stage back, runs the rANS states through
//     the chunk's steps and then writes their words and emits. Nothing in a
//     step but the state's own arithmetic waits on the step before.
// Every mbarrier wait traps after 4 s (mbarrier.cuh).
//
// The division of the chain, x1 / freq, is a multiply-high by the record's
// m and two shifts (Granlund and Montgomery, "Division by invariant integers
// using multiplication", 1994, fig. 4.1: exact for every u32 dividend and
// every divisor 1 <= d < 2^32); the producers compute m. The remainder never
// appears: (q << 16) + (x1 - q * freq) + start is x1 + start + q * (65536 -
// freq) mod 2^32, one multiply-add. (The chain with the u32 division
// x1 / freq instead took 4-6 % longer a pass on the H100; PERF.md.) An
// inactive lane (padding, or past n) gets the record of freq 65536 and
// start 0, which leaves its state as it is and never emits, so the chain
// has no branch.
//
// The record source is a template parameter. Bounds reads materialized
// starts, freqs and active [T, W] (the z pass's EntropyBottleneck tables,
// and the tests). GmmBounds<MODE, K> evaluates start = row[j] and next =
// row[j + 1], j = value - lo, of each symbol's guarded GMM row from its [K]
// scales, means and weights with gmm::entry (gmm_entry.cuh), the same code
// as gmm_bounds_kernel and the decoder's probes; symbol i is at (step i / W,
// lane i % W) and a lane is active when i < n. K = 4, the flagship's, and
// K = 1, the single-Gaussian (GSM) codec's (zero means, unit weights), are
// compile-time instances; any other K takes a runtime-K loop sized for
// kMaxK. The bits are the runtime loop's either way (gmm::entry). So the y
// passes' bounds never reach device memory.
//
// Bound on the card (chip_profile.py --encode, PERF.md): the GmmBounds
// producers' float32 arithmetic, at every T. A record is two entries (about
// 250 flops at K = 4 from 52 bytes of inputs, several hundred instructions
// with the IEEE divides' and square roots' checks), and 16 producer warps
// a CTA at W = 4096 keep the SM's instruction issue near full; a chunk then
// costs about the same with one active lane as with 32, so the serial floor
// (one lane) is the full pass's time, and it is not the chain's: the chain
// (a dependent multiply-high, two shifts and a multiply-add a step, its
// records already in registers) runs some 2x faster, as the Bounds source,
// whose producers only form records, shows. The design's answers: the
// slabs spread the producers over 128 SMs at W = 4096, the staging keeps
// device-memory latency off both roles, and the reciprocal and the
// registers keep the chain short, so nothing but the arithmetic is left.

constexpr int kSlab = 32;           // lanes a CTA: the chain warp's lanes
constexpr int kProducerWarps = 16;
constexpr int kChunk = kProducerWarps;  // steps a stage, one a producer warp
constexpr int kInStages = 2;        // chunks of inputs in flight
constexpr int kRecStages = 4;       // chunks of records between the roles
constexpr int kEncThreads = 32 * (1 + kProducerWarps);

// The record of a symbol: {m, start, freq, shift1 | shift2 << 8}.
__device__ __forceinline__ uint4 encode_record(uint32_t start, uint32_t freq) {
  const uint32_t d = max(freq, 1u);  // an active freq of 0 is not valid input
  const int l = 32 - __clz(d - 1);   // ceil(log2 d)
  const uint32_t a = (uint32_t)((1ull << l) - d);  // < d
  uint32_t m;
  if (d <= 65536u) {  // floor(2^32 a / d) by two u32 divisions (a < 2^16)
    const uint32_t hi = (a << 16) / d;
    m = (hi << 16) + (((a << 16) - hi * d) << 16) / d + 1u;
  } else {
    m = (uint32_t)(((uint64_t)a << 32) / d) + 1u;
  }
  return make_uint4(m, start, freq,
                    (uint32_t)min(l, 1) | ((uint32_t)max(l - 1, 0) << 8));
}

// freq 65536, start 0: x1 + 0 + q * 0 == x, and x >> 16 < 65536 never emits
__device__ __forceinline__ uint4 idle_record() {
  return make_uint4(1u, 0u, 65536u, 1u | (15u << 8));
}

__device__ __forceinline__ uint32_t record_quotient(const uint4& r,
                                                    uint32_t x) {
  const uint32_t t = __umulhi(r.x, x);
  return (t + ((x - t) >> (r.w & 0xFFu))) >> (r.w >> 8);
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// `words` 4-byte words from device memory into shared memory (16-byte
// aligned), by the 32 lanes of a warp.
__device__ __forceinline__ void stage_words(void* dst, const void* src,
                                            int words, int lane) {
  const uint32_t d = fg::smem_u32(dst);
  const char* s = (const char*)src;
  if ((((uintptr_t)s) & 15) == 0 && (words & 3) == 0) {
    for (int e = lane; e < words >> 2; e += 32) cp_async16(d + 16 * e, s + 16 * e);
  } else {
    for (int e = lane; e < words; e += 32) cp_async4(d + 4 * e, s + 4 * e);
  }
}

struct Bounds {
  using State = uint32_t;  // the final states, as fg_rans_encode has them
  const int32_t* starts;  // [T, W]
  const int32_t* freqs;
  const uint8_t* active;
  // a step's staging: starts [32], freqs [32], active [32 bytes]
  __host__ __device__ int step_words() const { return 2 * kSlab + kSlab / 4; }
  __device__ __forceinline__ void stage(uint32_t* dst, size_t i0, int nl,
                                        int lane) const {
    stage_words(dst, starts + i0, nl, lane);
    stage_words(dst + kSlab, freqs + i0, nl, lane);
    const uint8_t* a = active + i0;
    uint8_t* d = (uint8_t*)(dst + 2 * kSlab);
    if ((((uintptr_t)a) & 3) == 0 && (nl & 3) == 0) {
      stage_words(d, a, nl >> 2, lane);
    } else {  // plain copies, ordered for the warp by its next __syncwarp
      for (int e = lane; e < nl; e += 32) d[e] = a[e];
    }
  }
  __device__ __forceinline__ uint4 record(const uint32_t* st, int l,
                                          long long) const {
    const bool act = ((const uint8_t*)(st + 2 * kSlab))[l] != 0;
    return act ? encode_record(st[l], st[kSlab + l]) : idle_record();
  }
};

template <int MODE, int KC>
struct GmmBounds {
  static constexpr int kN = KC > 0 ? KC : gmm::kMaxK;  // parameters held
  using State = int64_t;  // the final states as the wrapper returns them
  const int32_t* values;  // [n]
  const float* scales;    // [n, K]
  const float* means;
  const float* weights;
  long long n;
  int K, lo, L;
  // a step's staging: values [32], scales, means, weights [32 * K] each
  __host__ __device__ int step_words() const { return kSlab * (1 + 3 * K); }
  __device__ __forceinline__ void stage(uint32_t* dst, size_t i0, int nl,
                                        int lane) const {
    const long long left = n - (long long)i0;
    const int cnt = left <= 0 ? 0 : (int)min((long long)nl, left);
    if (cnt == 0) return;
    const size_t g = i0 * (size_t)K;
    stage_words(dst, values + i0, cnt, lane);
    stage_words(dst + kSlab, scales + g, cnt * K, lane);
    stage_words(dst + kSlab * (1 + K), means + g, cnt * K, lane);
    stage_words(dst + kSlab * (1 + 2 * K), weights + g, cnt * K, lane);
  }
  __device__ __forceinline__ uint4 record(const uint32_t* st, int l,
                                          long long i) const {
    if (i >= n) return idle_record();
    const int k_n = KC > 0 ? KC : K;
    const float* p = (const float*)st + kSlab + l * k_n;
    float s[kN], m[kN], b[kN];
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      s[k] = 1.0f, m[k] = 0.0f, b[k] = 0.0f;
      if (k < k_n) {  // no read past the staging at runtime K
        s[k] = gmm::ftz(p[k]);
        m[k] = gmm::ftz(p[kSlab * k_n + k]);
        b[k] = gmm::term_b<MODE>(p[2 * kSlab * k_n + k]);
      }
    }
    const int j = (int)st[l] - lo;
    const int a = gmm::entry<MODE, KC>(s, m, b, K, lo, j, L);
    const int c = gmm::entry<MODE, KC>(s, m, b, K, lo, j + 1, L);
    return encode_record((uint32_t)a, (uint32_t)(c - a));
  }
};

// The chain warp: C chunks of records, from the last steps to the first.
template <class State>
__device__ __forceinline__ void encode_chain(const uint4* recs, uint32_t full0,
                                             uint32_t empty0, int C, int T,
                                             int W, int lane0, int nl,
                                             int lane, State* states,
                                             int32_t* words, uint8_t* emits) {
  uint32_t x = kRansL;
  for (int q = 0; q < C; ++q) {
    const int r = q % kRecStages;
    fg::mbar_wait(full0 + 8 * r, (q / kRecStages) & 1);
    // the chunk's records into registers, and the stage back at once; the
    // steps then wait on nothing but the state. Steps past T hold idle
    // records, so every chunk runs all its steps without a branch.
    const uint4* rec = recs + r * kChunk * kSlab + lane;
    uint4 rc[kChunk];
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) rc[tt] = rec[tt * kSlab];
    fg::mbar_arrive(empty0 + 8 * r);
    uint32_t w[kChunk];
    uint32_t em = 0;  // emit bits
#pragma unroll
    for (int tt = kChunk - 1; tt >= 0; --tt) {
      const uint32_t xs = x >> 16;
      const bool emit = xs >= rc[tt].z;  // x >= freq << 16, without overflow
      const uint32_t x1 = emit ? xs : x;
      const uint32_t qt = record_quotient(rc[tt], x1);
      w[tt] = x & 0xFFFFu;
      em |= (uint32_t)emit << tt;
      x = x1 + rc[tt].y + qt * (65536u - rc[tt].z);
    }
    if (lane < nl) {
      const int t0 = (C - 1 - q) * kChunk;
      size_t i = (size_t)t0 * W + lane0 + lane;
#pragma unroll
      for (int tt = 0; tt < kChunk; ++tt, i += W) {
        if (t0 + tt < T) {
          words[i] = (int32_t)w[tt];
          emits[i] = (uint8_t)((em >> tt) & 1u);
        }
      }
    }
  }
  if (lane < nl) states[lane0 + lane] = (State)x;
}

template <class Src>
__global__ void __launch_bounds__(kEncThreads, 1)
rans_encode_kernel(const Src src, int T, int W,
                   typename Src::State* __restrict__ states,
                   int32_t* __restrict__ words, uint8_t* __restrict__ emits) {
  extern __shared__ __align__(16) uint32_t dyn[];
  __shared__ __align__(8) uint64_t bars[2 * kRecStages];  // full, empty
  uint4* recs = (uint4*)dyn;  // [kRecStages][kChunk][kSlab]
  uint32_t* in = dyn + 4 * kRecStages * kChunk * kSlab;  // [kInStages][kChunk][step]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lane0 = blockIdx.x * kSlab;
  const int nl = min(kSlab, W - lane0);
  const int C = (T + kChunk - 1) / kChunk;
  const uint32_t full0 = fg::smem_u32(&bars[0]);
  const uint32_t empty0 = fg::smem_u32(&bars[kRecStages]);
  if (threadIdx.x == 0) {
    for (int r = 0; r < kRecStages; ++r) {
      fg::mbar_init(full0 + 8 * r, 32 * kProducerWarps);
      fg::mbar_init(empty0 + 8 * r, 32);
    }
  }
  __syncthreads();

  if (warp == 0) {
    encode_chain(recs, full0, empty0, C, T, W, lane0, nl, lane, states,
                 words, emits);
    return;
  }

  // producer warp p: step p of every chunk
  const int p = warp - 1;
  const int sw = src.step_words();
  auto fill = [&](int q) {  // stage chunk q (one cp.async group, maybe empty)
    const int t = (C - 1 - q) * kChunk + p;
    if (q < C && t < T)
      src.stage(in + ((q % kInStages) * kChunk + p) * sw,
                (size_t)t * W + lane0, nl, lane);
    cp_async_commit();
  };
  for (int q = 0; q < kInStages; ++q) fill(q);
  for (int q = 0; q < C; ++q) {
    cp_async_wait<kInStages - 1>();  // this warp's chunk q has landed
    __syncwarp();
    const int t = (C - 1 - q) * kChunk + p;
    uint4 rc = idle_record();
    if (t < T && lane < nl)
      rc = src.record(in + ((q % kInStages) * kChunk + p) * sw, lane,
                      (long long)t * W + lane0 + lane);
    const int r = q % kRecStages;
    fg::mbar_wait(empty0 + 8 * r, ((q / kRecStages) & 1) ^ 1);
    recs[(r * kChunk + p) * kSlab + lane] = rc;
    fg::mbar_arrive(full0 + 8 * r);
    __syncwarp();  // the warp is done with the stage: refill it
    fill(q + kInStages);
  }
}

// One CTA a slab of 32 lanes; the rings take 32 KB of records and
// 2 * 16 * step_words words of inputs (52 KB at K = 4).
template <class Src>
int launch_encode(const Src& src, int T, int W, void* states, void* words,
                  void* emits, cudaStream_t stream) {
  if (W < 1 || T < 0) return (int)cudaErrorInvalidValue;
  auto kernel = rans_encode_kernel<Src>;
  const int smem = 16 * kRecStages * kChunk * kSlab +
                   4 * kInStages * kChunk * src.step_words();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(W + kSlab - 1) / kSlab, kEncThreads, smem, stream>>>(
      src, T, W, (typename Src::State*)states, (int32_t*)words,
      (uint8_t*)emits);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_encode_gmm(const int32_t* v, const float* sc, const float* mu,
                      const float* wt, long long n, int K, int lo, int L,
                      int T, int W, void* states, void* words, void* emits,
                      cudaStream_t s) {
  if (K == 4)
    return launch_encode(GmmBounds<MODE, 4>{v, sc, mu, wt, n, K, lo, L}, T, W,
                         states, words, emits, s);
  if (K == 1)
    return launch_encode(GmmBounds<MODE, 1>{v, sc, mu, wt, n, K, lo, L}, T, W,
                         states, words, emits, s);
  return launch_encode(GmmBounds<MODE, 0>{v, sc, mu, wt, n, K, lo, L}, T, W,
                       states, words, emits, s);
}

// Decode. The stream offset g is global over all W lanes, so the lanes of a
// step must agree on it: each step ranks its consuming lanes by an exclusive
// scan over the whole pass, and lane order must stay the stream's order.
//
// The lanes are spread over one thread-block cluster of C CTAs (up to 16,
// one SM each). CTA r owns the contiguous lanes [r * per, (r + 1) * per),
// lane r * per + rr * blockDim.x + tid in its round rr and thread tid, so
// the (CTA, round, warp, thread) order is the lane order. Each step:
//   1. every lane searches its row for x & 0xFFFF and updates its state;
//      a warp ballot + popc ranks its consuming lanes inside the warp;
//   2. warp 0 scans the (round, warp) totals of its CTA and writes the CTA's
//      total into every peer's shared memory (distributed shared memory),
//      into the slot of this step's parity: a peer writes the same slot
//      again only two steps later, after the next cluster barrier, which
//      this CTA reaches only once it has read the slot;
//   3. one cluster barrier (its window evaluates the next step's first
//      probe, which does not depend on the state);
//   4. each lane's word is at g + (totals of the lower CTAs) + (its rank
//      inside its CTA).
// Lane states and ranks live in shared memory, so W is limited only by
// shared memory (2 words a lane of a CTA), not by registers.
//
// The row source is a template parameter. Rows reads materialized int32
// [T, W, L] rows (the z pass's EntropyBottleneck tables, and the tests).
// GmmRows evaluates row[j] on demand at each probe of the search with
// gmm::entry (gmm_entry.cuh), the same code the encoder's bounds and the
// full rows come from: about 7 entries a symbol instead of L = 98, and no
// rows tensor; K = 4, the flagship's, and K = 1, the GSM codec's, are
// compile-time instances (the runtime-K entry that any other K takes is
// much slower). A symbol's
// parameters do not depend on the rANS
// state, so a thread loads its next symbol's parameters into registers
// while it searches the current one. Both sources give count =
// #(row[j] <= cf) by bisection, so the rows must never decrease (the guarded
// rows do not: CDF entries plus j, capped by 65536); the two entries that
// bound the bin are the last probes on either side, so nothing is
// evaluated twice. On a row that decreases, the bisection's count may
// differ from the direct count of the plain version.
//
// Every thread of every CTA runs every step and reaches every barrier;
// inactive lanes are masked, never skipped. A stream read past n_stream (a
// desync) clamps and raises *err, so a bad stream fails instead of faulting.
// Bound on the card: latency. The steps are serial; a step is the dependent
// search (6 entries after the one in the barrier's window for GmmRows, or
// 7 dependent loads for Rows), the CTA scan, one cluster barrier and a
// dependent stream read. The cluster spreads the search work of the W lanes
// over C SMs, so a step costs about what one lane alone costs, not one
// SM's instruction throughput (chip_profile.py --decode measures both).

constexpr int kMaxCluster = 16;  // non-portable cluster size on Hopper
constexpr int kPortableCluster = 8;
constexpr int kMaxThreads = 512;  // 128 registers a thread
constexpr int kLanesPerCta = 256;  // the cluster size picked is W / 256
constexpr int kMaxDynSmem = 232448 - 1024;  // what a block may use, less static

struct Rows {
  const int32_t* rows;
  int L;
  struct Item {
    const int32_t* row;
  };
  __device__ __forceinline__ Item load(size_t i) const {
    return {rows + i * (size_t)L};
  }
  __device__ __forceinline__ void prepare(Item&) const {}
  __device__ __forceinline__ uint32_t at(const Item& it, int j) const {
    return (uint32_t)it.row[j];
  }
};

template <int MODE, int KC>
struct GmmRows {
  static constexpr int kN = KC > 0 ? KC : gmm::kMaxK;  // parameters held
  const float* scales;  // [n, K]: symbol i's parameters
  const float* means;
  const float* weights;
  long long n;
  int K, lo, L;
  struct Item {
    float s[kN], m[kN], b[kN];
  };
  __device__ __forceinline__ Item load(size_t i) const {
    Item it;
    const bool ok = (long long)i < n;  // padding lanes past n are inactive
    const size_t g = ok ? i * (size_t)K : 0;
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const bool in = ok && k < K;
      it.s[k] = in ? scales[g + k] : 1.0f;
      it.m[k] = in ? means[g + k] : 0.0f;
      it.b[k] = in ? weights[g + k] : 0.0f;
    }
    return it;
  }
  __device__ __forceinline__ void prepare(Item& it) const {
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      it.s[k] = gmm::ftz(it.s[k]);
      it.m[k] = gmm::ftz(it.m[k]);
      it.b[k] = gmm::term_b<MODE>(it.b[k]);
    }
  }
  __device__ __forceinline__ uint32_t at(const Item& it, int j) const {
    return (uint32_t)gmm::entry<MODE, KC>(it.s, it.m, it.b, K, lo, j, L);
  }
};

template <class Src>
__global__ void __launch_bounds__(kMaxThreads)
rans_decode_kernel(const Src src, const uint32_t* __restrict__ states,
                   const int32_t* __restrict__ stream, int64_t n_stream,
                   const uint8_t* __restrict__ active, int lo, int T, int W,
                   int per, int rounds, int32_t* __restrict__ out,
                   int32_t* __restrict__ err) {
  extern __shared__ uint32_t dyn[];
  __shared__ int s_total[2][kMaxCluster];  // [step parity][CTA]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5;
  const int lane_in_warp = tid & 31;
  const int nwarps = nthreads >> 5;
  const unsigned lt_mask = (1u << lane_in_warp) - 1u;
  const int nslots = rounds * nthreads;
  uint32_t* s_x = dyn;                           // [nslots] lane states
  int* s_within = (int*)(dyn + nslots);          // [nslots] rank in warp, or -1
  int* warp_cnt = s_within + nslots;             // [rounds * nwarps]
  int* warp_off = warp_cnt + rounds * nwarps;    // [rounds * nwarps]
  const int lane0 = rank * per;
  const int nlanes = max(0, min(per, W - lane0));

  // slot l = rr * nthreads + tid belongs to one thread from here on
  for (int l = tid; l < nslots; l += nthreads)
    s_x[l] = l < nlanes ? states[lane0 + l] : 0u;
  cluster.sync();  // every CTA runs before the first remote write

  // The next item's data does not depend on the rANS state: its loads are
  // started one item ahead, and with one round a step its first probe,
  // row[L / 2] (the bisection's first midpoint), is evaluated inside the
  // cluster barrier of the step before.
  typename Src::Item nxt{};
  uint8_t nact = 0;
  bool nready = false;  // nxt prepared and nfirst = its row[L / 2]
  uint32_t nfirst = 0u;
  auto fetch = [&](int t, int rr) {
    const int l = rr * nthreads + tid;
    nact = 0;
    nready = false;
    if (t < T && l < nlanes) {
      const size_t i = (size_t)t * W + lane0 + l;
      nxt = src.load(i);
      nact = active[i];
    }
  };
  fetch(0, 0);

  long long g = 0;  // words consumed before this step
  for (int t = 0; t < T; ++t) {
    for (int rr = 0; rr < rounds; ++rr) {
      const int l = rr * nthreads + tid;
      typename Src::Item cur = nxt;
      const bool act = nact != 0;
      const bool ready = nready;
      uint32_t first = nfirst;
      if (rr + 1 < rounds) fetch(t, rr + 1); else fetch(t + 1, 0);
      bool nd = false;
      if (act) {
        if (!ready) {
          src.prepare(cur);
          first = src.at(cur, src.L >> 1);
        }
        const uint32_t x = s_x[l];
        const uint32_t cf = x & 0xFFFFu;
        // count = #(row[j] <= cf); start = row[count - 1] (0 if count == 0)
        // and nxt = row[count] (65536 if count == L) are the last probes
        int a = 0, b = src.L;
        uint32_t start = 0u, next = 65536u;
        if (first <= cf) {  // the first midpoint, (0 + L) >> 1
          a = (src.L >> 1) + 1;
          start = first;
        } else {
          b = src.L >> 1;
          next = first;
        }
        while (a < b) {
          const int mid = (a + b) >> 1;
          const uint32_t v = src.at(cur, mid);
          if (v <= cf) {
            a = mid + 1;
            start = v;
          } else {
            b = mid;
            next = v;
          }
        }
        const int s = min(max(a - 1, 0), src.L - 2);
        const uint32_t xn = (next - start) * (x >> 16) + cf - start;
        nd = xn < kRansL;
        s_x[l] = xn;
        out[(size_t)t * W + lane0 + l] = lo + s;
      } else if (l < nlanes) {
        out[(size_t)t * W + lane0 + l] = 0;
      }
      const unsigned bal = __ballot_sync(0xffffffffu, nd);
      s_within[l] = nd ? __popc(bal & lt_mask) : -1;
      if (lane_in_warp == 0) warp_cnt[rr * nwarps + warp] = __popc(bal);
    }
    __syncthreads();

    if (warp == 0) {  // exclusive scan of the (round, warp) totals
      const int n = rounds * nwarps;
      const int per_lane = (n + 31) / 32;
      const int begin = lane_in_warp * per_lane;
      int local = 0;
      for (int k = 0; k < per_lane; ++k) {
        const int j = begin + k;
        if (j < n) local += warp_cnt[j];
      }
      int incl = local;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane_in_warp >= d) incl += v;
      }
      int run = incl - local;
      for (int k = 0; k < per_lane; ++k) {
        const int j = begin + k;
        if (j < n) {
          warp_off[j] = run;
          run += warp_cnt[j];
        }
      }
      const int total = __shfl_sync(0xffffffffu, incl, 31);
      if (lane_in_warp < csize)  // this CTA's total, into every CTA's slot
        *cluster.map_shared_rank(&s_total[t & 1][rank], lane_in_warp) = total;
    }
    // the cluster barrier, with the next step's first probe in its window
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
    if (rounds == 1 && nact) {
      src.prepare(nxt);
      nfirst = src.at(nxt, src.L >> 1);
      nready = true;
    }
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");

    long long below = 0, all = 0;
    for (int q = 0; q < csize; ++q) {
      const int v = s_total[t & 1][q];
      all += v;
      if (q < rank) below += v;
    }
    const long long base = g + below;
    g += all;
    for (int rr = 0; rr < rounds; ++rr) {
      const int l = rr * nthreads + tid;
      const int within = s_within[l];
      if (within >= 0) {
        long long idx = base + warp_off[rr * nwarps + warp] + within;
        if (idx >= n_stream) {
          *err = 1;
          idx = n_stream - 1;
        }
        const uint32_t word = idx >= 0 ? ((uint32_t)stream[idx] & 0xFFFFu) : 0u;
        s_x[l] = (s_x[l] << 16) | word;
      }
    }
  }
}

// One cluster of c = min(max_cluster, ceil(W / 256)) CTAs (16 at most; 8
// where more than 8 do not fit on the card).
template <class Src>
int launch_decode(const Src& src, const void* states, const void* words,
                  long long n_stream, const void* active, int lo, int T,
                  int W, int max_cluster, void* out, void* err,
                  cudaStream_t stream) {
  if (W < 1 || T < 0 || src.L < 2 || max_cluster < 1 ||
      max_cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  auto kernel = rans_decode_kernel<Src>;
  int c = min(max_cluster, (W + kLanesPerCta - 1) / kLanesPerCta);
  for (;;) {
    const int per = (W + c - 1) / c;
    const int threads = min(kMaxThreads, (per + 31) / 32 * 32);
    const int rounds = (per + threads - 1) / threads;
    const long long smem = 4LL * rounds * (2 * threads + 2 * (threads / 32));
    if (smem > kMaxDynSmem) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (c > kPortableCluster) {
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return (int)e;
    }
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)c);
    cfg.blockDim = dim3((unsigned)threads);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (c > kPortableCluster) {
      int fits = 0;
      e = cudaOccupancyMaxActiveClusters(&fits, kernel, &cfg);
      if (e != cudaSuccess || fits < 1) {
        (void)cudaGetLastError();
        c = kPortableCluster;
        continue;
      }
    }
    e = cudaLaunchKernelEx(&cfg, kernel, src, (const uint32_t*)states,
                           (const int32_t*)words, (int64_t)n_stream,
                           (const uint8_t*)active, lo, T, W, per, rounds,
                           (int32_t*)out, (int32_t*)err);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
}

// The GMM source at compile-time K for the flagship's K = 4 and the GSM
// codec's K = 1; any other K <= kMaxK takes the runtime-K loop.
template <int MODE>
int launch_decode_gmm(const float* sc, const float* mu, const float* wt,
                      long long n, int K, int lo, int L, const void* states,
                      const void* words, long long n_stream,
                      const void* active, int T, int W, int max_cluster,
                      void* out, void* err, cudaStream_t s) {
  if (K == 4)
    return launch_decode(GmmRows<MODE, 4>{sc, mu, wt, n, K, lo, L}, states,
                         words, n_stream, active, lo, T, W, max_cluster, out,
                         err, s);
  if (K == 1)
    return launch_decode(GmmRows<MODE, 1>{sc, mu, wt, n, K, lo, L}, states,
                         words, n_stream, active, lo, T, W, max_cluster, out,
                         err, s);
  return launch_decode(GmmRows<MODE, 0>{sc, mu, wt, n, K, lo, L}, states,
                       words, n_stream, active, lo, T, W, max_cluster, out,
                       err, s);
}

}  // namespace

extern "C" int fg_rans_encode(const void* starts, const void* freqs,
                              const void* active, int T, int W, void* states,
                              void* words, void* emits, void* stream) {
  const Bounds src{(const int32_t*)starts, (const int32_t*)freqs,
                   (const uint8_t*)active};
  return launch_encode(src, T, W, states, words, emits, (cudaStream_t)stream);
}

extern "C" int fg_rans_encode_gmm(const void* values, const void* scales,
                                  const void* means, const void* weights,
                                  long long n, int K, int lo, int L, int mode,
                                  int T, int W, void* states, void* words,
                                  void* emits, void* stream) {
  if (n < 1 || K < 1 || K > gmm::kMaxK || mode < 0 || mode > 2 || L < 2 ||
      W < 1 || T < 0 || n > (long long)T * W)
    return (int)cudaErrorInvalidValue;
  const int32_t* v = (const int32_t*)values;
  const float* sc = (const float*)scales;
  const float* mu = (const float*)means;
  const float* wt = (const float*)weights;
  auto launch = mode == 0 ? launch_encode_gmm<0>
                : mode == 1 ? launch_encode_gmm<1> : launch_encode_gmm<2>;
  return launch(v, sc, mu, wt, n, K, lo, L, T, W, states, words, emits,
                (cudaStream_t)stream);
}

extern "C" int fg_rans_decode(const void* states, const void* stream_words,
                              long long n_stream, const void* rows,
                              const void* active, int lo, int T, int W, int L,
                              int max_cluster, void* out, void* err,
                              void* stream) {
  const Rows src{(const int32_t*)rows, L};
  return launch_decode(src, states, stream_words, n_stream, active, lo, T, W,
                       max_cluster, out, err, (cudaStream_t)stream);
}

extern "C" int fg_rans_decode_gmm(const void* states, const void* stream_words,
                                  long long n_stream, const void* scales,
                                  const void* means, const void* weights,
                                  long long n, int K, const void* active,
                                  int lo, int T, int W, int L, int mode,
                                  int max_cluster, void* out, void* err,
                                  void* stream) {
  if (n < 1 || K < 1 || K > gmm::kMaxK || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const float* sc = (const float*)scales;
  const float* mu = (const float*)means;
  const float* wt = (const float*)weights;
  const cudaStream_t s = (cudaStream_t)stream;
  auto launch = mode == 0 ? launch_decode_gmm<0>
                : mode == 1 ? launch_decode_gmm<1> : launch_decode_gmm<2>;
  return launch(sc, mu, wt, n, K, lo, L, states, stream_words, n_stream,
                active, T, W, max_cluster, out, err, s);
}
