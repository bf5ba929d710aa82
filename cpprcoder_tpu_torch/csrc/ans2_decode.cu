// Kernel Y: CT-ANS2 (the adaptive interleaved rANS) decode on Hopper.
//
// It replaces no Pallas kernel: the JAX package runs this decode as scans
// over windows and steps (cpprcoder_tpu/ops/ans2_ops.py:183 `_decode_fn`,
// scans `:220` and `:236`), its symbols found by one-hot compares and its
// refills placed by a cumsum over the lanes (`:203-209`).
//
// What it computes (reference/ans2_ref.py): n bytes over K interleaved
// lanes (lane j's step t is byte t*K + j), all sharing one model and one
// u16 word stream in read order. At each window start (ans2_model.cuh):
// the counts take the last window's symbols (inc each), are rescaled,
// (c >> 1) | 1, if the total has reached 2^limit_log2, and normalized to
// the window's table. Each step, every active lane (t*K + j < n) takes
// slot = st & 0x3FFF, s = cum2sym[slot], st = f[s] * (st >> 14) + slot -
// c[s]; the lanes with st < 2^16 then read words base + #(refilling lanes
// before them), in lane order (0 past the stream's end), as st = st << 16 |
// word, and base moves past them all.
//
// Design: one CTA a stream (256 threads up to 256 lanes, a thread a lane
// up to 1,024, then 1,024 threads of K / 1,024 lanes each). A thread owns a
// contiguous run of lanes, so lane order is thread order and the refills'
// prefix count is a CTA scan: each thread's count of refilling lanes,
// scanned within the warp by shuffles, the warps' totals through shared
// memory (double-buffered by the step's parity, so one barrier a step).
// The lanes' states are in shared memory up to 32,768 lanes, in global
// scratch above. The model's update is order-free: a warp's lanes with one
// symbol are counted by __match_any_sync and one of them adds their number
// to the window's histogram (shared atomics); the counts take it at the
// next window start. There, after a barrier: the rescale, the normalize
// (ans2_model.cuh, shared with W), the table (f | c << 16) and a 2^14-byte
// cum2sym, each thread filling a run of slots from one binary search.
//
// What bounds it: the steps are sequential, each a barrier and, on a
// refilling lane's chain, the scan and one global read of a word; a window
// start adds the normalize (a few microseconds). One CTA: one SM of 132.
#include <cstdint>
#include <cuda_runtime.h>

#include "ans2_model.cuh"

namespace {

using namespace ans2;

constexpr int MIN_THREADS = 256;  // a thread a symbol for the normalize
constexpr int MAX_THREADS = 1024;
constexpr int SHARED_STATE_LANES = 1 << 15;
// dynamic shared memory: cum2sym (2^14 bytes), tab, hist, the scan's warp
// totals [2][32], then the states where they fit
constexpr int FIXED_WORDS = 4096 + 256 + 256 + 2 * MAX_WARPS;

int cta_threads(int K) { return K <= MIN_THREADS ? MIN_THREADS : (K < MAX_THREADS ? K : MAX_THREADS); }

// words [n_words] u16 (read order); states_in [K] u32; st_global [K] u32
// scratch where K > SHARED_STATE_LANES; out [n] u8.
__global__ void __launch_bounds__(MAX_THREADS, 1)
    ans2_decode_kernel(const uint16_t* __restrict__ words, unsigned long long n_words,
                       const uint32_t* __restrict__ states_in, uint32_t* st_global,
                       uint8_t* __restrict__ out, long long n, int K, int steps, uint32_t inc,
                       int limit_log2, int r) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ Scratch sc;
  uint32_t* const c2s_words = smem;
  const uint8_t* const cum2sym = (const uint8_t*)smem;
  uint32_t* const tab = smem + 4096;
  uint32_t* const hist = tab + 256;
  uint32_t* const wsum = hist + 256;
  uint32_t* const st = K <= SHARED_STATE_LANES ? wsum + 2 * MAX_WARPS : st_global;
  const int tid = threadIdx.x, T = blockDim.x, warp = tid >> 5, lane_w = tid & 31;
  const int warps = T >> 5;
  const int lpt = K > T ? K / T : 1;  // lanes a thread: [first, first + lpt)
  const int first = tid * lpt;
  const bool sym_thread = tid < 256;  // owns count[tid]
  const bool can_rescale = limit_log2 < 64;
  const unsigned long long limit = can_rescale ? 1ull << limit_log2 : 0;
  for (int i = tid; i < K; i += T) st[i] = states_in[i];
  if (sym_thread) hist[tid] = 0;
  unsigned long long cnt = sym_thread ? 1 : 0, total = 256, base = 0;
  uint32_t wstart = 0;  // the current window's first step
  __syncthreads();
  for (int t = 0; t < steps; ++t) {
    if (is_boundary(t, r)) {
      __syncthreads();  // the last step's updates and table reads are done
      if (t > 0) {
        if (sym_thread) {
          cnt += (unsigned long long)inc * hist[tid];
          hist[tid] = 0;
        }
        total += (unsigned long long)inc * coded(wstart, t, n, K);
        wstart = t;
      }
      if (can_rescale && total >= limit) {
        if (sym_thread) cnt = (cnt >> 1) | 1;
        total = block_sum(cnt, sc);
      }
      uint32_t c;
      const uint32_t f = normalize(cnt, sc, c);
      if (sym_thread) tab[tid] = f | (c << 16);
      __syncthreads();
      // cum2sym: each thread a run of 2^14 / T slots, its first symbol by
      // binary search (the last s with c[s] <= slot), then walked forward
      const int per = (int)TOTAL / T;
      uint32_t slot = (uint32_t)(tid * per);
      int s = 0;
      for (int step = 128; step; step >>= 1)
        if ((tab[s + step] >> 16) <= slot) s += step;
      uint32_t next = s < 255 ? tab[s + 1] >> 16 : TOTAL;
      for (int i = 0; i < per; i += 4) {
        uint32_t word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b, ++slot) {
          while (slot >= next) {
            ++s;
            next = s < 255 ? tab[s + 1] >> 16 : TOTAL;
          }
          word |= (uint32_t)s << (8 * b);
        }
        c2s_words[(tid * per + i) >> 2] = word;
      }
      __syncthreads();
    }
    const long long left = n - (long long)t * K;
    const int nact = left < K ? (int)left : K;
    const size_t row = (size_t)t * K;
    unsigned long long need = 0;  // bit l: lane first + l refills
    for (int l = 0; l < lpt; ++l) {
      const int lane = first + l;
      const bool act = lane < nact;
      uint32_t s = 256u + lane_w;  // matches no symbol, nor another lane
      if (act) {
        const uint32_t x = st[lane], slot = x & (TOTAL - 1);
        s = cum2sym[slot];
        const uint32_t e = tab[s];
        const uint32_t x2 = (e & 0xFFFFu) * (x >> PROB_BITS) + slot - (e >> 16);
        need |= (unsigned long long)(x2 < LOW) << l;
        st[lane] = x2;
        out[row + lane] = (uint8_t)s;
      }
      const uint32_t peers = __match_any_sync(FULL_MASK, s);
      if (act && lane_w == __ffs(peers) - 1) atomicAdd(&hist[s], (uint32_t)__popc(peers));
    }
    // the refilling lanes before this thread's: the warp's by shuffles,
    // the warps' through shared memory
    const uint32_t mine = (uint32_t)__popcll(need);
    uint32_t incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(FULL_MASK, incl, o);
      if (lane_w >= o) incl += y;
    }
    uint32_t* const ws = wsum + (t & 1) * MAX_WARPS;
    if (lane_w == 31) ws[warp] = incl;
    __syncthreads();
    uint32_t before = 0, all = 0;
    for (int i = 0; i < warps; ++i) {
      const uint32_t v = ws[i];
      before += i < warp ? v : 0u;
      all += v;
    }
    unsigned long long at = base + before + incl - mine;
    while (need) {
      const int l = __ffsll((long long)need) - 1;
      need &= need - 1;
      const uint32_t w = at < n_words ? (uint32_t)words[at] : 0u;
      ++at;
      st[first + l] = (st[first + l] << 16) | w;
    }
    base += all;
  }
}

}  // namespace

// words [n_words] u16 in read order, states [K] u32 (the container's) ->
// out [n] u8 (byte t*K + j is lane j's step t); scratch [K] u32 where K >
// 32,768, else unused. r is the effective refresh_log2 (at most 31),
// limit_log2 at most 63.
extern "C" int ct_ans2_decode(const void* words, long long n_words, const void* states,
                              void* scratch, void* out, long long n, int K, int steps, int inc,
                              int limit_log2, int r, void* stream) {
  if (K < 1 || K > 65536 || (K & (K - 1)) || n < 1 || steps < 1 ||
      n > (long long)K * steps || n <= (long long)K * (steps - 1) || n_words < 0 || inc < 0 ||
      inc > 255 || limit_log2 < 0 || limit_log2 > 63 || r < 0 || r > 31 ||
      (K > SHARED_STATE_LANES && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const int smem = 4 * (FIXED_WORDS + (K <= SHARED_STATE_LANES ? K : 0));
  cudaError_t e = cudaFuncSetAttribute(ans2_decode_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  ans2_decode_kernel<<<1, cta_threads(K), smem, (cudaStream_t)stream>>>(
      (const uint16_t*)words, (unsigned long long)n_words, (const uint32_t*)states,
      (uint32_t*)scratch, (uint8_t*)out, n, K, steps, (uint32_t)inc, limit_log2, r);
  return (int)cudaGetLastError();
}
