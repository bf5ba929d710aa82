// Kernels S and T: CT-ASE1 (the adaptive symbol encoder) on Hopper.
//
// They replace no Pallas kernel: the JAX package runs each direction as one
// compiled lax.scan (cpprcoder_tpu/ops/ase_ops.py:47 `_encode_fn`, scan :89,
// its words placed by rans_ops._stream_fn, :165-167; :103 `_decode_fn`, scan
// :148). The reference's coder is cppase.h:71-324.
//
// What they compute, per stream of n bytes over K interleaved lanes (lane i
// codes x[j*K + i] at step j, j < lane_len[i]), each lane with its own
// 64-entry recency table (size entries in use, `bits` = ENTROPY[size] as of
// the last append):
//   - a symbol at index idx < size is a hit: (d << 1) | 1 in bits + 1 bits,
//     d = size - 1 - idx, and entries idx+1..size-1 shift down, the symbol
//     going to the back;
//   - else a literal: sym << 1 in 9 bits, appended at `size` (then bits =
//     ceil(log2(size + 1))), or on a full table entry 0 is evicted (all
//     shift down) and the symbol goes to 63;
//   - bits LSB-first into u16 words, at most one word a symbol; a lane's
//     flush writes its partial word if it holds a bit.
// So for lane i at step t, with p its last step that coded the same byte
// (or -1), D the distinct bytes it coded at steps p+1..t-1 and N those at
// steps 0..t-1, the step is a hit iff p >= 0 and D < 64 (d = D, bits =
// ENTROPY[min(N, 64)]). S writes the lanes' bit counts and their words lane
// after lane; T reads them back (zeros past a lane's end, never past the
// payload's) and writes out[j*K + i].
//
// Design. Lanes share nothing. A table lives in registers, entry 4w + b
// in byte b of word w, so that every loop over it unrolls to fixed
// registers (no local memory): the find is a zero-byte test of (word ^
// sym*0x01010101) a word, masked to the entries in use (entries are
// distinct, so the lowest flagged byte of the lowest flagged word is the
// match: the test's false positives lie only above a true zero byte); the
// update builds each word from itself and its neighbour shifted a byte (a
// funnel shift), under byte masks of the moved range.
//   S (second round; the first was a thread a lane, its chain of ~430
//   instructions a step on 2 of the 132 SMs at K = 256). The encoder's
//   table is a function of the input alone: it is the lane's last 64
//   distinct bytes by recency. So a lane's steps are cut into segments of
//   L steps (ase_ops.segment_steps: K * stride / 2^15, at least 32; one a
//   lane from K = 2^15 on) that code side by side, each from its start
//   table. Six launches, no host read:
//     1. a thread a segment: its distinct bytes, newest first (at most 64),
//        and their 256-bit set, walking its steps backwards;
//     2. a warp a lane over its segments in order: the LRU composition (the
//        segment's bytes, then the earlier state's entries not among them,
//        cut at 64) gives each segment's start table;
//     3. a thread a segment: its bit count, coding its steps from its start
//        table (newest first: a hit's index is its distance d);
//     4. up to 32 threads a lane: its segments' bit offsets and bit count;
//     5. one CTA: the lanes' first words;
//     6. a thread a segment codes again and writes each word whose first
//        bit is its own, coding on into the next segment's steps to finish
//        the last (each word one writer, no atomics, nothing zeroed twice);
//        the other CTAs zero the payload past the last lane's words.
//   The scratch is 44 words a segment: at most 2^15 + K segments, 17.6 MB
//   whatever n. Measured and left out (PERF.md, section 6): T's quad a
//   lane with the first design's scan and copy (`s_quad`, ten times
//   slower at kennedy.xls), segments of a quarter and four times the
//   length, the find as a chain of selects.
//   T (second round; the first was S's thread a lane): a quad of 4 threads a
//   lane, 4 table words each, the coder state copied in each; the entry of a
//   hit is one shuffle from its owner, the update 4 words a thread and one
//   shuffle down; the lane's words come from registers loaded a group of 4
//   ahead, so no refill waits on global memory.
//
// What bounds them: S, pass 2's walk over a lane's segments (a chain of
// shuffles and shared round trips a segment), the coding passes' chains of
// L steps, and its six launches; T, each
// lane's steps, one dependent chain (entry, update, emit): at K = 256
// (kennedy.xls) only 256 lanes run, so the chain's latency, not the card's
// rate, sets the time; T's quad cuts the chain's table work to 4 words a
// thread, and spreads K = 256 over 32 SMs.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TABLE = 64;
constexpr int WORDS = TABLE / 4;   // u32 words of a table
constexpr int SEG_THREADS = 128;   // S: threads a CTA (passes 1, 3, 4 and 6)
constexpr int COMPOSE_WARPS = 4;   // S: lanes a CTA of pass 2
constexpr int COMPOSE_AHEAD = 4;   // S: segments pass 2 loads ahead
constexpr int PRE = 8;             // S: symbols passes 3 and 6 load ahead
constexpr int SCAN_THREADS = 1024;
constexpr int TAIL_CTAS = 264;     // S: CTAs that zero the payload's tail
constexpr uint32_t FULL = 0xFFFFFFFFu;

// The low c bytes set, c in 0..4.
__device__ __forceinline__ uint32_t low_bytes(int c) {
  return (uint32_t)((1ull << (8 * c)) - 1ull);
}

__device__ __forceinline__ int clamp4(int v) { return v < 0 ? 0 : v > 4 ? 4 : v; }

// The index of sym among the table's first `size` entries, or -1: the
// lowest entry flagged by the zero-byte tests, found in one 64-bit set.
__device__ __forceinline__ int find(const uint32_t (&tab)[WORDS], uint32_t sym, int size) {
  const uint32_t s4 = sym * 0x01010101u;
  unsigned long long hits = 0;  // bit 4w + b: entry 4w + b flagged
#pragma unroll
  for (int w = 0; w < WORDS; ++w) {
    const uint32_t d = tab[w] ^ s4;
    const uint32_t z = (d - 0x01010101u) & ~d & 0x80808080u & low_bytes(clamp4(size - 4 * w));
    // bits 7, 15, 23, 31 of z to bits 0..3 (the products fall on distinct bits)
    hits |= (unsigned long long)((((z >> 7) * 0x204081u) >> 21) & 0xFu) << (4 * w);
  }
  return __ffsll((long long)hits) - 1;
}

// ------------------------------------------------------------- kernel S
//
// Segment g = s*K + lane (lanes fastest) covers the lane's steps [s*L,
// min((s+1)*L, len)); G = K * ceil(stride / L) segments. Its scratch, in
// 32-bit words (ase_ops.segment_scratch_words):
//   start [G][16]  its start table, newest first, zero past its size
//   own   [G][16]  its distinct bytes, newest first (at most 64; u8)
//   omask [G][8]   the 256-bit set of its bytes
//   ocnt, ssize, sbits, soff [G]: min(distinct, 64), the start table's
//                  size, its bit count, its bit offset in its lane
//   lbase [K]      each lane's first word; total [1] the payload's words.

// Entries 0..end-1 of a newest-first table move to 1..end and entry 0
// takes sym: end = d for a hit at d (its old place), else min(size, 63) (a
// full table drops entry 63, its least recent).
__device__ __forceinline__ void mtf_update(uint32_t (&tab)[WORDS], int& size, uint32_t sym,
                                           bool hit, int d) {
  const int end = hit ? d : min(size, TABLE - 1);
  uint32_t prev = 0;
#pragma unroll
  for (int w = 0; w < WORDS; ++w) {
    const uint32_t cur = tab[w];
    const uint32_t shifted = __funnelshift_l(prev, cur, 8);  // entry 4w+b takes 4w+b-1
    const uint32_t ms = low_bytes(clamp4(end + 1 - 4 * w)) & (w == 0 ? 0xFFFFFF00u : ~0u);
    tab[w] = (cur & ~ms) | (shifted & ms);
    prev = cur;
  }
  tab[0] = (tab[0] & ~0xFFu) | sym;
  if (!hit && size < TABLE) ++size;
}

struct SegScratch {
  uint32_t* start;
  uint8_t* own;
  uint32_t* omask;
  int32_t *ocnt, *ssize;
  uint32_t *sbits, *soff;
  int32_t *lbase, *total;
};

inline SegScratch seg_scratch(void* p, size_t G) {
  uint32_t* w = (uint32_t*)p;
  SegScratch sc;
  sc.start = w;
  sc.own = (uint8_t*)(w + 16 * G);
  sc.omask = w + 32 * G;
  sc.ocnt = (int32_t*)(w + 40 * G);
  sc.ssize = (int32_t*)(w + 41 * G);
  sc.sbits = w + 42 * G;
  sc.soff = w + 43 * G;
  sc.lbase = (int32_t*)(w + 44 * G);
  sc.total = sc.lbase + 65536;  // after the largest K's lane bases
  return sc;
}

// Pass 1, a thread a segment: its steps walked backwards, each byte's first
// sight (its last occurrence) appended to its list while fewer than 64.
__global__ void __launch_bounds__(SEG_THREADS)
    ase_state_kernel(const uint8_t* __restrict__ x, const int32_t* __restrict__ lane_len,
                     SegScratch sc, int K, int kl, int stride, int L, int G) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const int lane = g & (K - 1), lo = (g >> kl) * L;
  const int hi = min(lo + L, min(max(lane_len[lane], 0), stride));
  // the set in shared memory, word w of thread i at mask[w][i] (no bank
  // conflict; in registers its dynamic index would put it in local memory)
  __shared__ uint32_t mask[8][SEG_THREADS];
  const int i = threadIdx.x;
#pragma unroll
  for (int w = 0; w < 8; ++w) mask[w][i] = 0;
  int cnt = 0;
  uint8_t* own = sc.own + (size_t)g * TABLE;
#pragma unroll 4
  for (int t = hi - 1; t >= lo; --t) {
    const uint32_t b = x[(size_t)t * K + lane];
    const uint32_t bit = 1u << (b & 31), m = mask[b >> 5][i];
    mask[b >> 5][i] = m | bit;
    if (!(m & bit) && cnt < TABLE) own[cnt++] = (uint8_t)b;
  }
  uint4* om = reinterpret_cast<uint4*>(sc.omask + (size_t)g * 8);
  om[0] = make_uint4(mask[0][i], mask[1][i], mask[2][i], mask[3][i]);
  om[1] = make_uint4(mask[4][i], mask[5][i], mask[6][i], mask[7][i]);
  sc.ocnt[g] = cnt;
}

// A segment's own state as pass 2 reads it, thread j's share: its entries
// j and j + 32, word j of its set (j < 8), its count.
struct OwnState {
  uint32_t a, b, m;
  int c;
};

__device__ __forceinline__ OwnState own_state(const SegScratch& sc, size_t g, int j) {
  return {sc.own[g * TABLE + j], sc.own[g * TABLE + 32 + j], j < 8 ? sc.omask[g * 8 + j] : 0u,
          sc.ocnt[g]};
}

// Pass 2, a warp a lane, over its segments in order: the state (newest
// first, thread j holding entries j and j + 32) is segment s's start table;
// then it becomes segment s's bytes, then the state's entries that are not
// among them, cut at 64 (the LRU composition). The segments' own states
// are loaded COMPOSE_AHEAD segments ahead, so the walk waits on no load.
__global__ void __launch_bounds__(COMPOSE_WARPS * 32)
    ase_compose_kernel(SegScratch sc, int K, int nseg) {
  __shared__ uint8_t tabs[COMPOSE_WARPS][TABLE];
  const int wp = threadIdx.x >> 5, j = threadIdx.x & 31;
  const int lane = blockIdx.x * COMPOSE_WARPS + wp;
  if (lane >= K) return;
  uint8_t* buf = tabs[wp];
  const uint32_t lt = (1u << j) - 1u;
  uint32_t a = 0, b = 0;
  int size = 0;
  OwnState q[COMPOSE_AHEAD];
#pragma unroll
  for (int p = 0; p < COMPOSE_AHEAD; ++p)
    q[p] = p < nseg ? own_state(sc, (size_t)p * K + lane, j) : OwnState{0, 0, 0, 0};
  for (int s0 = 0; s0 < nseg; s0 += COMPOSE_AHEAD) {
#pragma unroll
    for (int p = 0; p < COMPOSE_AHEAD; ++p) {
      const int s = s0 + p;
      if (s >= nseg) break;
      const size_t g = (size_t)s * K + lane;
      const OwnState o = q[p];
      if (s + COMPOSE_AHEAD < nseg) q[p] = own_state(sc, g + (size_t)COMPOSE_AHEAD * K, j);
      uint8_t* start = reinterpret_cast<uint8_t*>(sc.start + g * WORDS);
      start[j] = j < size ? (uint8_t)a : 0;
      start[j + 32] = j + 32 < size ? (uint8_t)b : 0;
      if (j == 0) sc.ssize[g] = size;
      // every thread shuffles (the entries past size too): the words of
      // the segment's set that hold its entries
      const uint32_t wa = __shfl_sync(FULL, o.m, (int)(a >> 5));
      const uint32_t wb = __shfl_sync(FULL, o.m, (int)(b >> 5));
      const bool ka = j < size && !((wa >> (a & 31)) & 1u);
      const bool kb = j + 32 < size && !((wb >> (b & 31)) & 1u);
      const uint32_t ba = __ballot_sync(FULL, ka), bb = __ballot_sync(FULL, kb);
      const int ra = o.c + __popc(ba & lt), rb = o.c + __popc(ba) + __popc(bb & lt);
      if (j < o.c) buf[j] = (uint8_t)o.a;
      if (j + 32 < o.c) buf[j + 32] = (uint8_t)o.b;
      if (ka && ra < TABLE) buf[ra] = (uint8_t)a;
      if (kb && rb < TABLE) buf[rb] = (uint8_t)b;
      __syncwarp();
      size = min(TABLE, o.c + __popc(ba) + __popc(bb));
      a = buf[j];
      b = buf[j + 32];
      __syncwarp();
    }
  }
}

// Passes 3 and 6, a thread a segment, from its start table: without WRITE
// its bit count; with WRITE the words whose first bit lies in its bits,
// coding on past its last step (into the next segment's, with the table
// that segment starts from) until the last of them is whole or the lane
// ends. Each word has one writer.
template <bool WRITE>
__global__ void __launch_bounds__(SEG_THREADS)
    ase_code_kernel(const uint8_t* __restrict__ x, const int32_t* __restrict__ lane_len,
                    SegScratch sc, uint16_t* __restrict__ payload, long long n_words, int K,
                    int kl, int stride, int L, int G, int code_blocks) {
  if (WRITE && (int)blockIdx.x >= code_blocks) {
    // the rest of the CTAs: zeros past the last lane's words, 8 a thread
    const long long p = *sc.total;
    const long long tid = (long long)(blockIdx.x - code_blocks) * blockDim.x + threadIdx.x;
    const long long step = (long long)(gridDim.x - code_blocks) * blockDim.x;
    for (long long q = (p >> 3) + tid; 8 * q < n_words; q += step) {
      if (8 * q >= p && 8 * q + 8 <= n_words) {
        reinterpret_cast<uint4*>(payload)[q] = make_uint4(0, 0, 0, 0);
      } else {
        for (long long m = max(8 * q, p); m < min(8 * q + 8, n_words); ++m) payload[m] = 0;
      }
    }
    return;
  }
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const int lane = g & (K - 1), lo = (g >> kl) * L;
  const int len = min(max(lane_len[lane], 0), stride);
  const int hi = min(lo + L, len);
  if (lo >= hi) {
    if (!WRITE) sc.sbits[g] = 0;
    return;
  }
  unsigned long long first = 0, last = 0, m = 0;
  uint32_t nb = 0;
  if (WRITE) {
    const unsigned long long b0 = (unsigned long long)sc.lbase[lane] * 16 + sc.soff[g];
    first = (b0 + 15) >> 4;
    last = (b0 + sc.sbits[g] - 1) >> 4;
    if (first > last) return;
    m = b0 >> 4;
    nb = (uint32_t)(b0 & 15);
  }
  uint32_t tab[WORDS];
  const uint4* st4 = reinterpret_cast<const uint4*>(sc.start + (size_t)g * WORDS);
#pragma unroll
  for (int i = 0; i < WORDS / 4; ++i) {
    const uint4 v = st4[i];
    tab[4 * i] = v.x, tab[4 * i + 1] = v.y, tab[4 * i + 2] = v.z, tab[4 * i + 3] = v.w;
  }
  int size = sc.ssize[g];
  int bits = size > 1 ? 32 - __clz(size - 1) : 0;
  uint32_t acc = 0, total = 0;
  const int stop = WRITE ? len : hi;
  // the symbols PRE steps at a time, each batch loaded during the one before
  uint32_t cur[PRE];
#pragma unroll
  for (int u = 0; u < PRE; ++u) cur[u] = lo + u < stop ? x[(size_t)(lo + u) * K + lane] : 0u;
  for (int t0 = lo; t0 < stop; t0 += PRE) {
    uint32_t nx[PRE];
#pragma unroll
    for (int u = 0; u < PRE; ++u)
      nx[u] = t0 + PRE + u < stop ? x[(size_t)(t0 + PRE + u) * K + lane] : 0u;
#pragma unroll
    for (int u = 0; u < PRE; ++u) {
      if (t0 + u >= stop) break;
      const uint32_t sym = cur[u];
      const int d = find(tab, sym, size);
      const bool hit = d >= 0;
      const uint32_t width = hit ? (uint32_t)bits + 1u : 9u;
      if (!WRITE) {
        total += width;
      } else {
        acc |= (hit ? ((uint32_t)d << 1) | 1u : sym << 1) << nb;
        nb += width;
        if (nb >= 16) {
          if (m >= first) payload[m] = (uint16_t)acc;
          if (m == last) return;
          ++m;
          acc >>= 16;
          nb -= 16;
        }
      }
      if (!hit && size < TABLE) bits = 32 - __clz(size);
      mtf_update(tab, size, sym, hit, d);
    }
#pragma unroll
    for (int u = 0; u < PRE; ++u) cur[u] = nx[u];
  }
  if (!WRITE) {
    sc.sbits[g] = total;
  } else if (nb > 0 && m >= first) {
    payload[m] = (uint16_t)acc;  // the lane's last word, partial
  }
}

// Pass 4, tpl threads a lane (a power of two up to 32, at least the
// segments a lane where it can): each segment's bit offset in its lane, a
// scan of tpl segments at a time, and the lane's bit count.
__global__ void __launch_bounds__(SEG_THREADS)
    ase_lane_kernel(SegScratch sc, uint32_t* __restrict__ bits_out, int K, int nseg, int tpl) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = t / tpl, j = t & (tpl - 1);
  const bool real = lane < K;  // whole warps stay, for the shuffles
  uint32_t carry = 0;
  for (int s0 = 0; s0 < nseg; s0 += tpl) {
    const int s = s0 + j;
    const size_t g = (size_t)s * K + lane;
    const uint32_t v = real && s < nseg ? sc.sbits[g] : 0u;
    uint32_t incl = v;
    for (int d = 1; d < tpl; d <<= 1) {
      const uint32_t y = __shfl_up_sync(FULL, incl, d, tpl);
      if (j >= d) incl += y;
    }
    if (real && s < nseg) sc.soff[g] = carry + incl - v;
    carry += __shfl_sync(FULL, incl, tpl - 1, tpl);
  }
  if (real && j == 0) bits_out[lane] = carry;
}

// Pass 5, one CTA: the lanes' first words, an exclusive scan of their word
// counts (each thread a run of lanes), and the payload's word count.
__global__ void __launch_bounds__(SCAN_THREADS)
    ase_scan_kernel(const uint32_t* __restrict__ bits, int32_t* __restrict__ lbase,
                    int32_t* __restrict__ total, int K) {
  __shared__ int32_t warp_sum[SCAN_THREADS / 32];
  const int tid = threadIdx.x, ln = tid & 31, wp = tid >> 5;
  const int per = (K + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min(tid * per, K), hi = min(lo + per, K);
  // from K = 4,096 on a run is a multiple of 4 lanes, read 16 bytes a load
  const bool vec = per % 4 == 0;
  int32_t s = 0;
  if (vec) {
#pragma unroll 4
    for (int i = lo; i < hi; i += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(bits + i);
      s += (int32_t)(((v.x + 15) >> 4) + ((v.y + 15) >> 4) + ((v.z + 15) >> 4) + ((v.w + 15) >> 4));
    }
  } else {
    for (int i = lo; i < hi; ++i) s += (int32_t)((bits[i] + 15) >> 4);
  }
  int32_t incl = s;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(FULL, incl, d);
    if (ln >= d) incl += y;
  }
  if (ln == 31) warp_sum[wp] = incl;
  __syncthreads();
  if (wp == 0) {
    int32_t v = warp_sum[ln], vi = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(FULL, vi, d);
      if (ln >= d) vi += y;
    }
    warp_sum[ln] = vi - v;
    if (ln == 31) *total = vi;
  }
  __syncthreads();
  int32_t off = warp_sum[wp] + incl - s;
  if (vec) {
#pragma unroll 4
    for (int i = lo; i < hi; i += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(bits + i);
      int4 o;
      o.x = off;
      o.y = o.x + (int32_t)((v.x + 15) >> 4);
      o.z = o.y + (int32_t)((v.y + 15) >> 4);
      o.w = o.z + (int32_t)((v.z + 15) >> 4);
      off = o.w + (int32_t)((v.w + 15) >> 4);
      *reinterpret_cast<int4*>(lbase + i) = o;
    }
  } else {
    for (int i = lo; i < hi; ++i) {
      lbase[i] = off;
      off += (int32_t)((bits[i] + 15) >> 4);
    }
  }
}

// ------------------------------------------------------------- kernel T

// Thread q of a lane's quad holds table words 4q..4q+3 (entries
// 16q..16q+15): entry(idx) is thread idx >> 4's, and word 4q+3's successor
// is thread q+1's word 0.
constexpr int QUAD = 4;
constexpr int QWORDS = WORDS / QUAD;  // table words a thread of a quad holds
// T's CTA: one warp, 8 lanes (at K = 256, 32 CTAs on 32 SMs). Each warp's
// step is a chain of shared-nothing ALU work and shuffles; measured against
// CTAs of 64 and 128 threads (compare_kernels.py's t_cta64, t_cta128), the
// one-warp CTA, whose launch bound lets the compiler schedule the chain
// for one warp, was 3-4% faster at every shape timed.
constexpr int DEC_THREADS = 32;

// Entry idx (0..63) of the quad's table; every thread of the quad calls it
// with the same idx (and every thread of the warp calls it).
__device__ __forceinline__ uint32_t quad_entry(const uint32_t (&tab)[QWORDS], int idx) {
  const int w = (idx >> 2) & (QWORDS - 1);
  const uint32_t v = w == 0 ? tab[0] : w == 1 ? tab[1] : w == 2 ? tab[2] : tab[3];
  return __shfl_sync(FULL, (v >> (8 * (idx & 3))) & 0xFFu, idx >> 4, QUAD);
}

// The table after coding sym (hit at idx, or a miss), as ase_ops._update:
// entries start..place-1 take their successor, entry place takes sym. A
// place of -1 (a hit in an empty table, only from a corrupt container)
// changes nothing. Thread q of the quad moves its words 4q..4q+3 (every
// thread of the warp calls it).
__device__ __forceinline__ void quad_update(uint32_t (&tab)[QWORDS], int q, int& size,
                                            uint32_t sym, bool hit, int idx) {
  const bool full = size >= TABLE;
  const int start = hit ? idx : full ? 0 : size;
  const int place = hit ? size - 1 : full ? TABLE - 1 : size;
  const uint32_t s4 = sym * 0x01010101u;
  const uint32_t after = __shfl_down_sync(FULL, tab[0], 1, QUAD);
#pragma unroll
  for (int w = 0; w < QWORDS; ++w) {
    const int gw = QWORDS * q + w;
    const uint32_t nxt = w + 1 < QWORDS ? tab[w + 1] : q == QUAD - 1 ? 0u : after;
    const uint32_t shifted = __funnelshift_r(tab[w], nxt, 8);
    const uint32_t ms = low_bytes(clamp4(place - 4 * gw)) & ~low_bytes(clamp4(start - 4 * gw));
    const uint32_t mp = (place >= 0 && (place >> 2) == gw) ? 0xFFu << (8 * (place & 3)) : 0u;
    tab[w] = (tab[w] & ~(ms | mp)) | (shifted & ms) | (s4 & mp);
  }
  if (!hit && !full) ++size;
}

// Word i of the payload, 0 outside [0, end).
__device__ __forceinline__ uint32_t word_at(const uint16_t* __restrict__ words, long long i,
                                            long long end) {
  return i >= 0 && i < end ? (uint32_t)words[i] : 0u;
}

// words [P] u16, lane i's from bases[i], counts[i] of them; out [n] u8,
// out[j*K + i] for j < lane_len[i]. A quad a lane; the warp runs the longest
// of its lanes' steps, a quad past its lane's length writing nothing.
__global__ void __launch_bounds__(DEC_THREADS)
    ase_decode_kernel(const uint16_t* __restrict__ words, long long P,
                      const int32_t* __restrict__ bases, const int32_t* __restrict__ counts,
                      const int32_t* __restrict__ lane_len, uint8_t* __restrict__ out, int K,
                      int stride) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = g / QUAD, q = g % QUAD;
  const bool real = lane < K;
  const int len = real ? min(max(lane_len[lane], 0), stride) : 0;
  const int steps = __reduce_max_sync(FULL, len);
  long long cur = real ? bases[lane] : 0;
  long long end = real ? cur + (long long)max(counts[lane], 0) : 0;
  end = end < P ? end : P;
  // the words: grp the current group of 4 (left of them unread, the next
  // lowest), a0..a3 the group after it, loaded a group ahead
  uint64_t grp = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) grp |= (uint64_t)word_at(words, cur + i, end) << (16 * i);
  uint32_t a0 = word_at(words, cur + 4, end), a1 = word_at(words, cur + 5, end),
           a2 = word_at(words, cur + 6, end), a3 = word_at(words, cur + 7, end);
  cur += 8;
  int left = 4;
  uint32_t tab[QWORDS];
#pragma unroll
  for (int w = 0; w < QWORDS; ++w) tab[w] = 0;
  int size = 0, bits = 0;
  uint32_t win = 0, nb = 0;
  for (int t = 0; t < steps; ++t) {
    if (nb <= 16) {
      if (left == 0) {
        grp = (uint64_t)a0 | (uint64_t)a1 << 16 | (uint64_t)a2 << 32 | (uint64_t)a3 << 48;
        left = 4;
        a0 = word_at(words, cur, end), a1 = word_at(words, cur + 1, end);
        a2 = word_at(words, cur + 2, end), a3 = word_at(words, cur + 3, end);
        cur += 4;
      }
      win |= (uint32_t)(grp & 0xFFFFu) << nb;
      grp >>= 16;
      --left;
      nb += 16;
    }
    const bool hit = win & 1u;
    const int d = (int)((win >> 1) & ((1u << bits) - 1u));
    const int idx = max(size - 1 - d, 0);
    const uint32_t e = quad_entry(tab, idx);
    const uint32_t sym = hit ? e : (win >> 1) & 0xFFu;
    const uint32_t used = hit ? 1u + (uint32_t)bits : 9u;
    if (!hit && size < TABLE) bits = 32 - __clz(size);
    quad_update(tab, q, size, sym, hit, idx);
    win >>= used;
    nb -= used;
    if (q == 0 && t < len) out[(size_t)t * K + lane] = (uint8_t)sym;
  }
}

}  // namespace

// Kernel S: x [stride, K] u8, lane_len [K] i32 -> payload [K*cap] u16 (the
// lanes' words lane after lane, zero past them), bits [K]; scratch of
// ase_ops.segment_scratch_words(K, stride, L) words. K a power of two up to
// 65,536, cap = ceil(9*stride / 16), K*cap < 2^31, L >= 1 steps a segment.
// Six launches, no host read.
extern "C" int ct_ase_encode(const void* x, const void* lane_len, void* scratch, void* bits,
                             void* payload, int K, int stride, int L, void* stream) {
  const long long cap = (9ll * stride + 15) / 16;
  const long long nseg = stride > 0 && L > 0 ? (stride + (long long)L - 1) / L : 0;
  if (K < 1 || K > 65536 || (K & (K - 1)) || stride < 0 || L < 1 || (long long)K * cap >= (1ll << 31) ||
      (long long)K * nseg >= (1ll << 25))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int G = (int)(K * nseg), kl = __builtin_ctz((unsigned)K);
  if (G == 0) return (int)cudaMemsetAsync(bits, 0, (size_t)K * 4, st);
  const SegScratch sc = seg_scratch(scratch, (size_t)G);
  const int blocks = (G + SEG_THREADS - 1) / SEG_THREADS;
  ase_state_kernel<<<blocks, SEG_THREADS, 0, st>>>((const uint8_t*)x, (const int32_t*)lane_len, sc,
                                                   K, kl, stride, L, G);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ase_compose_kernel<<<(K + COMPOSE_WARPS - 1) / COMPOSE_WARPS, COMPOSE_WARPS * 32, 0, st>>>(
      sc, K, (int)nseg);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ase_code_kernel<false><<<blocks, SEG_THREADS, 0, st>>>(
      (const uint8_t*)x, (const int32_t*)lane_len, sc, nullptr, 0, K, kl, stride, L, G, blocks);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  int tpl = 1;
  while (tpl < nseg && tpl < 32) tpl <<= 1;
  ase_lane_kernel<<<(int)(((long long)K * tpl + SEG_THREADS - 1) / SEG_THREADS), SEG_THREADS, 0,
                    st>>>(sc, (uint32_t*)bits, K, (int)nseg, tpl);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ase_scan_kernel<<<1, SCAN_THREADS, 0, st>>>((const uint32_t*)bits, sc.lbase, sc.total, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ase_code_kernel<true><<<blocks + TAIL_CTAS, SEG_THREADS, 0, st>>>(
      (const uint8_t*)x, (const int32_t*)lane_len, sc, (uint16_t*)payload, K * cap, K, kl, stride,
      L, G, blocks);
  return (int)cudaGetLastError();
}

// Kernel T: words [P] u16, bases and counts [K] i32, lane_len [K] i32 ->
// out [n] u8.
extern "C" int ct_ase_decode(const void* words, long long P, const void* bases,
                             const void* counts, const void* lane_len, void* out, int K,
                             int stride, void* stream) {
  if (K < 1 || K > 65536 || (K & (K - 1)) || stride < 0 || P < 0)
    return (int)cudaErrorInvalidValue;
  // whole warps: a warp's quads past K run with no lane
  ase_decode_kernel<<<(QUAD * K + DEC_THREADS - 1) / DEC_THREADS, DEC_THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const uint16_t*)words, P, (const int32_t*)bases, (const int32_t*)counts,
      (const int32_t*)lane_len, (uint8_t*)out, K, stride);
  return (int)cudaGetLastError();
}
