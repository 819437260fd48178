// Interleaved 32-bit rANS encode and decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels flashgmm_tpu/ans/pallas_coder.py::
// _encode_kernel and ::_decode_kernel. Same math as the plain versions in
// flashgmm_tpu_torch/ans/interleaved.py: W lanes, symbol i at (step i / W,
// lane i % W), state in [2^16, 2^32), 16-bit probabilities, at most one u16
// word per lane and step.
//
// Plain C interface (built by flashgmm_tpu_torch/_build.py with nvcc into one
// shared library, loaded with ctypes). Every entry launches on the caller's
// stream and returns cudaGetLastError() after the launch.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "gmm_entry.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t kRansL = 1u << 16;

// Encode: one thread per lane walks t = T-1 ... 0 with the state in a
// register. Native u32 division is exact, so no float divmod is needed.
// Bound on the card: bytes (each step reads 9 and writes 5 bytes per lane;
// the division is a few dozen integer operations).
__global__ void rans_encode_kernel(const int32_t* __restrict__ starts,
                                   const int32_t* __restrict__ freqs,
                                   const uint8_t* __restrict__ active,
                                   int T, int W,
                                   uint32_t* __restrict__ states,
                                   int32_t* __restrict__ words,
                                   uint8_t* __restrict__ emits) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= W) return;
  uint32_t x = kRansL;
  for (int t = T - 1; t >= 0; --t) {
    const size_t i = (size_t)t * W + lane;
    const bool act = active[i] != 0;
    const uint32_t freq = (uint32_t)freqs[i];
    const uint32_t start = (uint32_t)starts[i];
    const bool emit = act && (x >= (freq << 16));
    words[i] = (int32_t)(x & 0xFFFFu);
    emits[i] = emit ? 1 : 0;
    if (act) {  // inactive (padding) lanes may carry freq 0: never divide
      const uint32_t x1 = emit ? (x >> 16) : x;
      x = ((x1 / freq) << 16) + (x1 % freq) + start;
    }
  }
  states[lane] = x;
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
// rows tensor; K = 4, the flagship's, is a compile-time instance (the
// runtime-K entry that any other K takes is much slower). A symbol's
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

// The GMM source at compile-time K for the flagship's K = 4; any other
// K <= kMaxK takes the runtime-K loop.
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
  return launch_decode(GmmRows<MODE, 0>{sc, mu, wt, n, K, lo, L}, states,
                       words, n_stream, active, lo, T, W, max_cluster, out,
                       err, s);
}

}  // namespace

extern "C" int fg_rans_encode(const void* starts, const void* freqs,
                              const void* active, int T, int W, void* states,
                              void* words, void* emits, void* stream) {
  const int threads = 128;
  const int blocks = (W + threads - 1) / threads;
  rans_encode_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)starts, (const int32_t*)freqs, (const uint8_t*)active,
      T, W, (uint32_t*)states, (int32_t*)words, (uint8_t*)emits);
  return (int)cudaGetLastError();
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
