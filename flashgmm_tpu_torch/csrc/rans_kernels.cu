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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kRansL = 1u << 16;
constexpr int kMaxRounds = 4;  // decode: W <= 4 * 1024 lanes in one CTA

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

// Decode: one CTA walks one pass stream through all T steps. The stream
// offset g is global over all W lanes, so the lanes of a step must agree on
// it: each step ranks its consuming lanes with a CTA-wide exclusive scan
// (warp ballot + popc, then the warp totals in shared memory, scanned by
// warp 0). Lane of round r and thread tid is r * blockDim.x + tid, so the
// (round, warp) order of the totals is the lane order.
//
// Every thread runs every step and reaches every __syncthreads(); inactive
// lanes are masked, never skipped. A stream read past n_stream (a desync)
// clamps and raises *err, so a bad stream fails instead of faulting.
// Bound on the card: one SM (one CTA per stream) and the latency of the
// dependent row search and stream read of each step.
__global__ void __launch_bounds__(1024)
rans_decode_kernel(const uint32_t* __restrict__ states,
                   const int32_t* __restrict__ stream, int64_t n_stream,
                   const int32_t* __restrict__ rows,
                   const uint8_t* __restrict__ active,
                   int lo, int T, int W, int L, int rounds,
                   int32_t* __restrict__ out, int32_t* __restrict__ err) {
  __shared__ int warp_cnt[kMaxRounds * 32];
  __shared__ int warp_off[kMaxRounds * 32];
  __shared__ long long s_g;     // words consumed before the current step
  __shared__ long long s_base;  // s_g as the current step found it

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5;
  const int lane_in_warp = tid & 31;
  const int nwarps = nthreads >> 5;
  const unsigned lt_mask = (1u << lane_in_warp) - 1u;

  uint32_t x[kMaxRounds];
#pragma unroll
  for (int r = 0; r < kMaxRounds; ++r) {
    const int lane = r * nthreads + tid;
    x[r] = (r < rounds && lane < W) ? states[lane] : 0u;
  }
  if (tid == 0) s_g = 0;

  for (int t = 0; t < T; ++t) {
    uint32_t x2[kMaxRounds];
    int sym[kMaxRounds];
    bool need[kMaxRounds];
    int within[kMaxRounds];
#pragma unroll
    for (int r = 0; r < kMaxRounds; ++r) {
      if (r < rounds) {  // uniform over the CTA
        const int lane = r * nthreads + tid;
        const size_t i = (size_t)t * W + lane;
        const bool act = lane < W && active[i] != 0;
        bool nd = false;
        uint32_t xn = x[r];
        int s = 0;
        if (act) {
          const int32_t* row = rows + i * (size_t)L;
          const uint32_t cf = x[r] & 0xFFFFu;
          // count = #(row[j] <= cf) over the non-decreasing row
          int a = 0, b = L;
          while (a < b) {
            const int mid = (a + b) >> 1;
            if ((uint32_t)row[mid] <= cf) a = mid + 1; else b = mid;
          }
          const int count = a;
          s = min(max(count - 1, 0), L - 2);
          const uint32_t start = count > 0 ? (uint32_t)row[count - 1] : 0u;
          const uint32_t nxt = count < L ? (uint32_t)row[count] : 65536u;
          const uint32_t freq = nxt - start;
          xn = freq * (x[r] >> 16) + cf - start;
          nd = xn < kRansL;
        }
        sym[r] = act ? lo + s : 0;
        need[r] = nd;
        x2[r] = act ? xn : x[r];
        const unsigned bal = __ballot_sync(0xffffffffu, nd);
        within[r] = __popc(bal & lt_mask);
        if (lane_in_warp == 0) warp_cnt[r * nwarps + warp] = __popc(bal);
      }
    }
    __syncthreads();

    if (warp == 0) {  // exclusive scan of the (round, warp) totals
      const int n = rounds * nwarps;
      const int per = (n + 31) / 32;
      const int begin = lane_in_warp * per;
      int local = 0;
      for (int k = 0; k < per; ++k) {
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
      for (int k = 0; k < per; ++k) {
        const int j = begin + k;
        if (j < n) {
          warp_off[j] = run;
          run += warp_cnt[j];
        }
      }
      const int total = __shfl_sync(0xffffffffu, incl, 31);
      if (lane_in_warp == 0) {
        s_base = s_g;
        s_g += total;
      }
    }
    __syncthreads();

    const long long base = s_base;
#pragma unroll
    for (int r = 0; r < kMaxRounds; ++r) {
      if (r < rounds) {
        const int lane = r * nthreads + tid;
        if (lane < W) {
          uint32_t xr = x2[r];
          if (need[r]) {
            long long idx = base + warp_off[r * nwarps + warp] + within[r];
            if (idx >= n_stream) {
              *err = 1;
              idx = n_stream - 1;
            }
            const uint32_t word =
                idx >= 0 ? ((uint32_t)stream[idx] & 0xFFFFu) : 0u;
            xr = (xr << 16) | word;
          }
          x[r] = xr;
          out[(size_t)t * W + lane] = sym[r];
        }
      }
    }
  }
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
                              void* out, void* err, void* stream) {
  const int threads = W >= 1024 ? 1024 : ((W + 31) / 32) * 32;
  const int rounds = (W + threads - 1) / threads;
  if (W < 1 || L < 2 || rounds > kMaxRounds) return (int)cudaErrorInvalidValue;
  rans_decode_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)states, (const int32_t*)stream_words,
      (int64_t)n_stream, (const int32_t*)rows, (const uint8_t*)active, lo, T,
      W, L, rounds, (int32_t*)out, (int32_t*)err);
  return (int)cudaGetLastError();
}
