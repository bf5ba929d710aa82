// CT-ANS2's model on the card, for kernels W (ans2_encode.cu) and Y
// (ans2_decode.cu): the window schedule, CTA-wide sums and scans, and the
// exact normalize of 256 counts to a table summing to 2^14.
//
// The normalize is models/static_table.normalize_freqs bit for bit (the
// JAX package's twin is cpprcoder_tpu/models/table_jax.py:51-102), a thread
// a symbol (threads 0..255 of a CTA of at least 256):
//   1. pre-scale: shift = max(0, bitlen(n - 1) - 14), n the counts' sum
//      (64-bit); c = count >> shift, and a present count that became 0 is 1.
//      Then c <= 2^14, so c << 14 fits a u32;
//   2. floor scale: f = c * 2^14 / n', r = c * 2^14 % n', n' = sum of c;
//   3. a present symbol with f = 0 gets f = 1;
//   4. d = 2^14 - sum of f. d > 0: +1 to the d present symbols of largest r
//      (ties to the lower symbol, absent ones last), by rank counting: a
//      symbol's rank is #{r' > r} + #{s' < s, r' = r}. d < 0: the deficit is
//      taken from the richest symbols first (f descending, ties to the lower
//      symbol), each giving clip(need - (sum of the excess f - 1 before it),
//      0, f - 1); the sum before it again by counting;
//   5. if one symbol holds all of 2^14, it gives 1 to symbol (s + 1) % 256.
// CT-ANS2's counts never fall below 1 (they start at 1, and a rescale
// leaves (c >> 1) | 1), so every symbol is present and rule 5 cannot fire
// on the codec's path; the normalize is written whole all the same, and
// `ct_ans2_normalize` runs it alone on any count vector for the tests.
//
// The rank counts are 256 shared reads a thread, one normalize a few
// microseconds on 8 warps: W runs a CTA a window, all at once; Y one at
// each window start.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ans2 {

constexpr uint32_t PROB_BITS = 14;
constexpr uint32_t TOTAL = 1u << PROB_BITS;
constexpr uint32_t LOW = 1u << 16;
constexpr uint32_t FULL_MASK = 0xFFFFFFFFu;
constexpr int NORM_THREADS = 256;  // a thread a symbol
constexpr int MAX_WARPS = 32;

// Window w's first step at refresh_log2 r (r <= 31): 0, then 1, 2, 4, ...,
// 2^(r-1), then multiples of 2^r.
__host__ __device__ __forceinline__ unsigned long long window_start(unsigned long long w, int r) {
  if (w == 0) return 0;
  return w <= (unsigned long long)r ? 1ull << (w - 1) : (w - r) << r;
}

// The table (window) that codes step t: reference/ans2_ref.snapshot_index.
__device__ __forceinline__ uint32_t snapshot_index(uint32_t t, int r) {
  if (t < (1u << r)) return t == 0 ? 0u : 32u - __clz(t);
  return (uint32_t)r + (t >> r);
}

// Whether a window starts at step t.
__device__ __forceinline__ bool is_boundary(uint32_t t, int r) {
  return t < (1u << r) ? (t & (t - 1)) == 0 : (t & ((1u << r) - 1)) == 0;
}

// Positions of the steps [a, b) that code a symbol: [a*K, b*K) cut at n.
__host__ __device__ __forceinline__ unsigned long long coded(unsigned long long a,
                                                             unsigned long long b,
                                                             unsigned long long n, int K) {
  const unsigned long long lo = a * K < n ? a * K : n, hi = b * K < n ? b * K : n;
  return hi - lo;
}

struct Scratch {
  unsigned long long red[MAX_WARPS];
  uint32_t part[MAX_WARPS];
  uint32_t key[256];
  uint32_t ex[256];
  int full;
};

// The CTA's sum of v, to every thread (blockDim a multiple of 32). Two
// barriers: sc.red is free again when it returns.
__device__ __forceinline__ unsigned long long block_sum(unsigned long long v, Scratch& sc) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) sc.red[warp] = v;
  __syncthreads();
  unsigned long long s = 0;
  for (int i = 0; i < warps; ++i) s += sc.red[i];
  __syncthreads();
  return s;
}

// The CTA's exclusive prefix sum of v in thread order (the sum of the
// threads before this one). Two barriers.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v, Scratch& sc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) sc.part[warp] = incl;
  __syncthreads();
  uint32_t base = 0;
  for (int i = 0; i < warp; ++i) base += sc.part[i];
  __syncthreads();
  return base + incl - v;
}

// normalize_freqs(counts, 14), counts[s] held by thread s < 256 (threads
// past 255 pass anything and get 0). -> f of the thread's symbol; c gets
// its exclusive cumulative frequency. Every thread of the CTA must call it.
__device__ inline uint32_t normalize(unsigned long long cnt, Scratch& sc, uint32_t& c_out) {
  const int tid = threadIdx.x;
  const bool mine = tid < 256;
  if (!mine) cnt = 0;
  const unsigned long long n = block_sum(cnt, sc);
  if (n == 0) {  // no symbol: the all-zero table
    c_out = 0;
    return 0;
  }
  const int bitlen = 64 - __clzll((long long)(n - 1));
  const int shift = bitlen > (int)PROB_BITS ? bitlen - (int)PROB_BITS : 0;
  const bool present = cnt > 0;
  uint32_t c = (uint32_t)(cnt >> shift);
  if (present && c == 0) c = 1;
  const uint32_t np = (uint32_t)block_sum(c, sc);
  const uint32_t scaled = c << PROB_BITS;
  uint32_t f = scaled / np;
  const uint32_t r = scaled - f * np;
  if (present && f == 0) f = 1;
  const int d = (int)TOTAL - (int)block_sum(f, sc);
  if (d > 0) {
    // rank by remainder, descending; absent symbols rank last (key 0)
    const uint32_t key = present ? r + 1 : 0;
    if (mine) sc.key[tid] = key;
    __syncthreads();
    if (present) {
      int rank = 0;
      for (int s = 0; s < 256; ++s) {
        const uint32_t o = sc.key[s];
        rank += (o > key) | ((o == key) & (s < tid));
      }
      f += rank < d;
    }
    __syncthreads();
  } else if (d < 0) {
    // the richest first: the excess of the symbols before this one
    if (mine) {
      sc.key[tid] = f;
      sc.ex[tid] = present ? f - 1 : 0;
    }
    __syncthreads();
    if (present) {
      int before = 0;
      for (int s = 0; s < 256; ++s) {
        const uint32_t o = sc.key[s];
        if (o > f || (o == f && s < tid)) before += (int)sc.ex[s];
      }
      const int ex = (int)f - 1;
      const int take = min(max(-d - before, 0), ex);
      f -= (uint32_t)take;
    }
    __syncthreads();
  }
  if (tid == 0) sc.full = -1;
  __syncthreads();
  if (mine && f == TOTAL) sc.full = tid;
  __syncthreads();
  const int full = sc.full;
  if (full >= 0) {
    if (tid == full) f -= 1;
    if (tid == ((full + 1) & 255)) f += 1;
  }
  if (!mine) f = 0;
  c_out = block_exclusive_scan(f, sc);
  return f;
}

}  // namespace ans2
