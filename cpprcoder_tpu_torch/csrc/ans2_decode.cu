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
// Design (second round; the first read each refill word from global memory
// after a barrier of at least 256 threads a step, the states in shared
// memory). One CTA a stream. The steps run on `ts` threads (geometry()):
// one warp up to WARP_LANES lanes, else a thread a lane up to 1,024 lanes,
// then 1,024 threads of K / 1,024 lanes each. A thread owns a contiguous
// run of lanes, so lane order is thread order and the refills' prefix
// count is a scan: within the warp by shuffles, across warps through shared
// memory (double-buffered by the step's parity) and a named barrier of the
// `ts` stepping threads alone. One warp needs no barrier: __syncwarp.
//   - The words are staged in shared memory: a ring of RING_CHUNK-word
//     chunks (16 KiB up to 1,024 lanes, 8 words a lane up to 8,192, 4 or 2
//     at 16,384 and 32,768; none at 65,536), which thread 0 fills ahead of
//     base by cp.async.bulk, each chunk completing on an mbarrier of its
//     slot; a slot is refilled once base has passed its chunk. The refill
//     reads the ring, past the last whole 16 bytes of the stream global
//     memory (0 past its end).
//   - A thread's states stay in registers up to 8 lanes a thread (8,192
//     lanes), above in shared memory (16,384) or global scratch (32,768 and
//     65,536), laid out [lane in the thread][thread].
//   - The model's update is order-free, and its counts take a window's
//     symbols only at the next window start: each step a stepping lane adds
//     its symbol to its warp's copy of the window's histogram (a copy a
//     warp, mod 8: one shared atomic, no match of the warp's lanes). At a
//     window start every thread of the CTA (at least 256: a thread a
//     symbol for the histogram) joins after a CTA barrier: the copies
//     summed into the counts (in shared memory), then warp 0 alone the
//     rescale and the normalize (ans2_model.cuh's warp functions, shared
//     with W: 8 counts a lane, no CTA barrier inside) and the table (f | c
//     << 16), then every thread a 2^14-byte cum2sym, each filling a run of
//     slots from one binary search. The other threads wait there while the
//     stepping ones run the window's steps.
// Measured and left out (PERF.md, section 6): the histogram counted back
// from the output at window starts (its atomics on a few hot bins, with or
// without a warp's lanes grouped by __match_any_sync), the chunks landed
// tested and published by thread 0 each step, or waited on by it a step
// ahead, so that a refill need not wait (each slower: the test or wait on
// thread 0's chain every step), and one warp with K / 32 lanes a thread at
// 64 and 256 lanes (WARP_LANES; variants y_warp64, y_warp256).
//
// What bounds it: the steps are sequential, each a scan over the stepping
// threads (a named barrier past one warp) and, on a refilling lane's chain,
// the ring's read; a window start adds the normalize (a few microseconds).
// One CTA: one SM of 132.
#include <cstdint>
#include <cuda_runtime.h>

#include "ans2_model.cuh"

namespace {

using namespace ans2;

constexpr int MIN_THREADS = 256;  // a thread a symbol for the window's histogram
constexpr int MAX_THREADS = 1024;
constexpr int WARP_LANES = 32;    // one warp runs the steps up to this many lanes
constexpr int REG_LANES = 8;      // a thread's states in registers up to this many
constexpr int SHARED_STATE_LANES = 1 << 14;  // states in shared memory up to here
constexpr int RING_CHUNK = 1024;              // words a chunk of the ring (2 KiB)
constexpr int RING_LANES = 1 << 15;           // the words staged up to here
// dynamic shared memory: the ring, cum2sym (2^14 bytes), tab, hist, the
// scan's warp totals [2][32], the ring's mbarriers, then the states where
// they are kept there
constexpr int HIST_COPIES = 8;  // the window's histogram, a copy a warp (mod 8)
constexpr int FIXED_WORDS = 4096 + 256 + HIST_COPIES * 256 + 2 * MAX_WARPS;
constexpr int MAX_SLOTS = 64;

struct Geometry {
  int ts;       // threads that run the steps
  int lpt;      // lanes a stepping thread
  int threads;  // the CTA
  int ring;     // ring words (0: none)
  bool shared_states;
};

Geometry geometry(int K) {
  Geometry g;
  g.ts = K <= WARP_LANES ? 32 : (K < MAX_THREADS ? K : MAX_THREADS);
  g.lpt = K > g.ts ? K / g.ts : 1;
  g.threads = g.ts < MIN_THREADS ? MIN_THREADS : g.ts;
  const int want = 8 * K < 8192 ? 8192 : 8 * K;
  g.ring = K > RING_LANES ? 0 : (want < 65536 ? want : 65536);
  g.shared_states = g.lpt > REG_LANES && K <= SHARED_STATE_LANES;
  return g;
}

int smem_bytes(const Geometry& g, int K) {
  return 2 * g.ring + 4 * FIXED_WORDS + 8 * MAX_SLOTS + (g.shared_states ? 4 * K : 0);
}

// The staged word stream: chunk i (words [i*RING_CHUNK, ...) of the
// stream's first n16 words, n16 = n_words rounded down to 8) goes to slot
// i % slots of the ring, completing on that slot's mbarrier, phase i /
// slots. Thread 0 of the stepping threads issues; a stepping thread that
// reads chunk i waits on its phase unless it has read chunk i already (a
// thread's reads only move forward).
struct Ring {
  uint16_t* buf;
  uint64_t* bar;
  const uint16_t* words;
  unsigned long long n_words, n16, n_chunks;
  int slots;       // a power of two
  int slot_shift;  // log2(slots)
  unsigned long long issued;  // thread 0's count of chunks issued
  unsigned long long ready;   // this thread has waited on chunk ready - 1

  // Thread 0: every chunk whose slot base has freed (the chunk slots before
  // it wholly consumed: every read below base is done by now).
  __device__ __forceinline__ void issue(unsigned long long base) {
    const unsigned long long free_to = base / RING_CHUNK + slots;
    bool any = false;
    while (issued < n_chunks && issued < free_to) {
      if (!any) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      any = true;
      const unsigned long long at = issued * RING_CHUNK;
      const unsigned long long left = n16 - at;
      const uint32_t bytes = 2u * (uint32_t)(left < RING_CHUNK ? left : RING_CHUNK);
      uint64_t* b = bar + (issued & (slots - 1));
      uint16_t* dst = buf + (issued & (slots - 1)) * RING_CHUNK;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(b)),
                   "r"(bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];" ::"r"(smem_addr(dst)),
          "l"(words + at), "r"(bytes), "r"(smem_addr(b))
          : "memory");
      ++issued;
    }
  }

  // The word at `at` (0 past the stream's end).
  __device__ __forceinline__ uint32_t word(unsigned long long at) {
    if (at >= n16) return at < n_words ? (uint32_t)words[at] : 0u;
    const unsigned long long c = at / RING_CHUNK;
    if (c >= ready) {
      mbar_wait(bar + (c & (slots - 1)), (uint32_t)(c >> slot_shift) & 1u);
      ready = c + 1;
    }
    return buf[at & ((unsigned long long)slots * RING_CHUNK - 1)];
  }

  // Thread 0, at the end: no copy may still be landing in the CTA's
  // shared memory.
  __device__ __forceinline__ void drain() {
    for (unsigned long long c = issued > (unsigned long long)slots ? issued - slots : 0;
         c < issued; ++c)
      mbar_wait(bar + (c & (slots - 1)), (uint32_t)(c >> slot_shift) & 1u);
  }
};

// The stepping threads' barrier: __syncwarp for one warp, else a named
// barrier (id 1) of the ts threads.
__device__ __forceinline__ void step_sync(int ts) {
  if (ts == 32)
    __syncwarp();
  else
    asm volatile("bar.sync 1, %0;" ::"r"(ts) : "memory");
}

// One lane's step: -> its symbol; x becomes its state before the refill,
// and `need` whether it refills.
__device__ __forceinline__ uint32_t decode_lane(uint32_t& x, const uint8_t* cum2sym,
                                                const uint32_t* tab, bool& need) {
  const uint32_t slot = x & (TOTAL - 1);
  const uint32_t s = cum2sym[slot];
  const uint32_t e = tab[s];
  x = (e & 0xFFFFu) * (x >> PROB_BITS) + slot - (e >> 16);
  need = x < LOW;
  return s;
}

// The refilling lanes before this thread's (an exclusive scan of `mine`
// over the stepping threads), and `all` of them; one sync of the stepping
// threads, whose warp totals go to ws (one half of the double buffer).
__device__ __forceinline__ uint32_t refills_before(uint32_t mine, int ts, uint32_t* ws,
                                                   uint32_t& all) {
  const int lane_w = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane_w >= o) incl += y;
  }
  if (ts == 32) {
    all = __shfl_sync(FULL_MASK, incl, 31);
    __syncwarp();
    return incl - mine;
  }
  if (lane_w == 31) ws[warp] = incl;
  step_sync(ts);
  uint32_t before = 0;
  all = 0;
  for (int i = 0; i < ts >> 5; ++i) {
    const uint32_t v = ws[i];
    before += i < warp ? v : 0u;
    all += v;
  }
  return before + incl - mine;
}

// Warp 0 at a window start: the rescale where it is due and the normalize
// (ans2_model.cuh, shared with W), 8 counts a lane, no CTA barrier inside;
// the counts from and (rescaled) back to cnt in shared memory, the table
// (f | c << 16) into tab, the total into *total_out. Not inlined: its
// registers stay out of the steps' loop (inlined, the kernel spilled).
__device__ __noinline__ void window_table(unsigned long long* cnt, uint32_t* tab, bool rescale,
                                          unsigned long long total,
                                          unsigned long long* total_out) {
  const int lane = threadIdx.x & 31;
  unsigned long long c8[PER_LANE];
  ulonglong2* wc = reinterpret_cast<ulonglong2*>(cnt + PER_LANE * lane);
#pragma unroll
  for (int i = 0; i < PER_LANE / 2; ++i) {
    const ulonglong2 v = wc[i];
    c8[2 * i] = v.x, c8[2 * i + 1] = v.y;
  }
  if (rescale) {
    warp_rescale(c8, total);
#pragma unroll
    for (int i = 0; i < PER_LANE / 2; ++i) wc[i] = make_ulonglong2(c8[2 * i], c8[2 * i + 1]);
  }
  uint32_t f[PER_LANE], c[PER_LANE];
  warp_normalize(c8, f, c);
  uint4* tb = reinterpret_cast<uint4*>(tab + PER_LANE * lane);
  tb[0] = make_uint4(f[0] | c[0] << 16, f[1] | c[1] << 16, f[2] | c[2] << 16, f[3] | c[3] << 16);
  tb[1] = make_uint4(f[4] | c[4] << 16, f[5] | c[5] << 16, f[6] | c[6] << 16, f[7] | c[7] << 16);
  if (lane == 0) *total_out = total;
}

// words [n_words] u16 (read order, 16-byte aligned); states_in [K] u32;
// st_global [K] u32 scratch where the states are kept there; out [n] u8.
// LPT > 0: a stepping thread's LPT lanes' states in registers; LPT = 0:
// g.lpt lanes a thread, in shared memory (SHARED_ST) or st_global.
template <int LPT, bool SHARED_ST>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    ans2_decode_kernel(const uint16_t* __restrict__ words, unsigned long long n_words,
                       const uint32_t* __restrict__ states_in, uint32_t* st_global,
                       uint8_t* __restrict__ out, long long n, int K, int steps, uint32_t inc,
                       int limit_log2, int r, int ts, int lpt_rt, int ring_words) {
  extern __shared__ __align__(128) uint32_t smem[];
  // the model's counts, which warp 0 rescales and normalizes at a window
  // start, and the total it leaves
  __shared__ __align__(16) unsigned long long wcnt[256];
  __shared__ unsigned long long wtotal;
  const int lpt = LPT > 0 ? LPT : lpt_rt;
  const int slots = ring_words / RING_CHUNK;
  uint16_t* const ring = reinterpret_cast<uint16_t*>(smem);
  uint32_t* const c2s_words = smem + ring_words / 2;
  const uint8_t* const cum2sym = reinterpret_cast<const uint8_t*>(c2s_words);
  uint32_t* const tab = c2s_words + 4096;
  uint32_t* const hist = tab + 256;
  uint32_t* const wsum = hist + HIST_COPIES * 256;
  uint64_t* const bars = reinterpret_cast<uint64_t*>(wsum + 2 * MAX_WARPS);
  uint32_t* const st = SHARED_ST ? reinterpret_cast<uint32_t*>(bars + MAX_SLOTS) : st_global;
  const int tid = threadIdx.x, T = blockDim.x;
  const bool stepping = tid < ts;
  const int first = tid * lpt;  // lanes [first, first + lpt)
  const bool sym_thread = tid < 256;  // adds symbol tid's histogram to its count
  const bool can_rescale = limit_log2 < 64;
  const unsigned long long limit = can_rescale ? 1ull << limit_log2 : 0;

  Ring rg;
  rg.buf = ring;
  rg.bar = bars;
  rg.words = words;
  rg.n_words = n_words;
  rg.n16 = ring_words ? n_words & ~7ull : 0;  // no ring: every word from global memory
  rg.n_chunks = (rg.n16 + RING_CHUNK - 1) / RING_CHUNK;
  rg.slots = slots;
  rg.slot_shift = 31 - __clz(slots > 0 ? slots : 1);
  rg.issued = 0;
  rg.ready = 0;
  if (tid < slots) mbar_init(bars + tid);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  uint32_t xs[LPT > 0 ? LPT : 1];
  if (LPT > 0) {
#pragma unroll
    for (int l = 0; l < (LPT > 0 ? LPT : 1); ++l)
      xs[l] = stepping && first + l < K ? states_in[first + l] : 0u;
  } else {
    for (int i = tid; i < K; i += T) st[(i % lpt) * ts + i / lpt] = states_in[i];
  }
  for (int i = tid; i < HIST_COPIES * 256; i += T) hist[i] = 0;
  if (sym_thread) wcnt[tid] = 1;
  __syncthreads();
  if (tid == 0) rg.issue(0);
  unsigned long long total = 256, base = 0;
  unsigned long long wstart = 0;  // the last window's first step
  for (unsigned long long w = 0;; ++w) {
    const unsigned long long t0 = window_start(w, r);
    if (t0 >= (unsigned long long)steps) break;
    const unsigned long long t1w = window_start(w + 1, r);
    const int t1 = t1w < (unsigned long long)steps ? (int)t1w : steps;
    // a window start: the last window's steps and their counts are done
    __syncthreads();
    if (w > 0) {
      if (sym_thread) {
        uint32_t h = 0;
#pragma unroll
        for (int c = 0; c < HIST_COPIES; ++c) {
          h += hist[c * 256 + tid];
          hist[c * 256 + tid] = 0;
        }
        wcnt[tid] += (unsigned long long)inc * h;
      }
      total += (unsigned long long)inc * coded(wstart, t0, n, K);
      wstart = t0;
    }
    __syncthreads();
    if (tid < 32) window_table(wcnt, tab, can_rescale && total >= limit, total, &wtotal);
    __syncthreads();
    total = wtotal;
    // cum2sym: each thread a run of 2^14 / T slots, its first symbol by
    // binary search (the last s with c[s] <= slot), then walked forward
    {
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
    }
    __syncthreads();
    if (!stepping) continue;
    uint32_t* const whist = hist + ((tid >> 5) & (HIST_COPIES - 1)) * 256;
    for (int t = (int)t0; t < t1; ++t) {
      const long long left = n - (long long)t * K;
      const int nact = left < K ? (int)left : K;
      uint8_t* const row = out + (size_t)t * K;
      unsigned long long need = 0;  // bit l: lane first + l refills
      if (LPT > 0) {
#pragma unroll
        for (int l = 0; l < (LPT > 0 ? LPT : 1); ++l) {
          const int lane = first + l;
          const bool act = lane < nact;
          if (act) {
            bool nd;
            const uint32_t s = decode_lane(xs[l], cum2sym, tab, nd);
            need |= (unsigned long long)nd << l;
            row[lane] = (uint8_t)s;
            atomicAdd(whist + s, 1u);
          }
        }
      } else {
        for (int l = 0; l < lpt; ++l) {
          const int lane = first + l;
          const bool act = lane < nact;
          if (act) {
            uint32_t x = st[l * ts + tid];
            bool nd;
            const uint32_t s = decode_lane(x, cum2sym, tab, nd);
            need |= (unsigned long long)nd << l;
            st[l * ts + tid] = x;
            row[lane] = (uint8_t)s;
            atomicAdd(whist + s, 1u);
          }
        }
      }
      uint32_t all;
      const uint32_t before =
          refills_before((uint32_t)__popcll(need), ts, wsum + (t & 1) * MAX_WARPS, all);
      // every read below base is done: the ring's freed slots are refilled
      if (tid == 0) rg.issue(base);
      unsigned long long at = base + before;
      if (LPT > 0) {
#pragma unroll
        for (int l = 0; l < (LPT > 0 ? LPT : 1); ++l)
          if ((need >> l) & 1u) xs[l] = (xs[l] << 16) | rg.word(at++);
      } else {
        while (need) {
          const int l = __ffsll((long long)need) - 1;
          need &= need - 1;
          st[l * ts + tid] = (st[l * ts + tid] << 16) | rg.word(at++);
        }
      }
      base += all;
    }
  }
  if (tid == 0) rg.drain();
}

template <int LPT, bool SHARED_ST>
cudaError_t launch(const Geometry& g, const void* words, long long n_words, const void* states,
                   void* scratch, void* out, long long n, int K, int steps, int inc,
                   int limit_log2, int r, cudaStream_t stream) {
  const int smem = smem_bytes(g, K);
  cudaError_t e = cudaFuncSetAttribute(ans2_decode_kernel<LPT, SHARED_ST>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  ans2_decode_kernel<LPT, SHARED_ST><<<1, g.threads, smem, stream>>>(
      (const uint16_t*)words, (unsigned long long)n_words, (const uint32_t*)states,
      (uint32_t*)scratch, (uint8_t*)out, n, K, steps, (uint32_t)inc, limit_log2, r, g.ts, g.lpt,
      g.ring);
  return cudaGetLastError();
}

}  // namespace

// words [n_words] u16 in read order (16-byte aligned), states [K] u32 (the
// container's) -> out [n] u8 (byte t*K + j is lane j's step t); scratch
// [K] u32 where K > 16,384 (the states in global memory), else unused. r is
// the effective refresh_log2 (at most 31), limit_log2 at most 63.
extern "C" int ct_ans2_decode(const void* words, long long n_words, const void* states,
                              void* scratch, void* out, long long n, int K, int steps, int inc,
                              int limit_log2, int r, void* stream) {
  const Geometry g = geometry(K > 0 ? K : 1);
  if (K < 1 || K > 65536 || (K & (K - 1)) || n < 1 || steps < 1 ||
      n > (long long)K * steps || n <= (long long)K * (steps - 1) || n_words < 0 || inc < 0 ||
      inc > 255 || limit_log2 < 0 || limit_log2 > 63 || r < 0 || r > 31 ||
      ((uintptr_t)words & 15) || (g.lpt > REG_LANES && !g.shared_states && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (g.lpt > REG_LANES ? 0 : g.lpt) {
    case 1:
      return (int)launch<1, false>(g, words, n_words, states, scratch, out, n, K, steps, inc,
                                   limit_log2, r, s);
    case 2:
      return (int)launch<2, false>(g, words, n_words, states, scratch, out, n, K, steps, inc,
                                   limit_log2, r, s);
    case 4:
      return (int)launch<4, false>(g, words, n_words, states, scratch, out, n, K, steps, inc,
                                   limit_log2, r, s);
    case 8:
      return (int)launch<8, false>(g, words, n_words, states, scratch, out, n, K, steps, inc,
                                   limit_log2, r, s);
    default:
      return (int)(g.shared_states
                       ? launch<0, true>(g, words, n_words, states, scratch, out, n, K, steps,
                                         inc, limit_log2, r, s)
                       : launch<0, false>(g, words, n_words, states, scratch, out, n, K, steps,
                                          inc, limit_log2, r, s));
  }
}
