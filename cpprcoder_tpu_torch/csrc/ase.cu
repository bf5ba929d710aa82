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
// S writes the lanes' bit counts and their words lane after lane; T reads
// them back (zeros past a lane's end, never past the payload's) and writes
// out[j*K + i].
//
// Design. Lanes share nothing. The table lives in registers, entry 4w + b
// in byte b of word w, so that every loop over it unrolls to fixed
// registers (no local memory): the find is a zero-byte test of (word ^
// sym*0x01010101) a word, masked to the entries in use (entries are
// distinct, so the lowest flagged byte of the lowest flagged word is the
// match: the test's false positives lie only above a true zero byte); the
// update builds each word from itself and the next one shifted down a byte
// (a funnel shift), under byte masks of the moved range and the symbol's
// place.
//   S: a thread a lane, its table in 16 registers. It prefetches its next
//   symbol a step ahead and writes its words to a padded word-major area
//   [cap, K]; a one-CTA scan of the word counts gives each lane's offset, and
//   a warp a lane copies its words to their place.
//   T (second round; the first was S's thread a lane): a quad of 4 threads a
//   lane, 4 table words each, the coder state copied in each; the entry of a
//   hit is one shuffle from its owner, the update 4 words a thread and one
//   shuffle down; the lane's words come from registers loaded a group of 4
//   ahead, so no refill waits on global memory.
//
// What bounds them: each lane's steps are one dependent chain (find or
// entry, update, emit), and at K = 256 (kennedy.xls) only 256 lanes run: the
// chain's latency, not the card's rate, sets the time. T's quad cuts the
// chain's table work to 4 words a thread, and spreads K = 256 over 32 SMs.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TABLE = 64;
constexpr int WORDS = TABLE / 4;   // u32 words of a table
constexpr int THREADS = 128;       // lanes a CTA (S and T)
constexpr int SCAN_THREADS = 1024;
constexpr int COPY_WARPS = 8;      // lanes a CTA of the copy

// The low c bytes set, c in 0..4.
__device__ __forceinline__ uint32_t low_bytes(int c) {
  return (uint32_t)((1ull << (8 * c)) - 1ull);
}

__device__ __forceinline__ int clamp4(int v) { return v < 0 ? 0 : v > 4 ? 4 : v; }

// The index of sym among the table's first `size` entries, or -1.
__device__ __forceinline__ int find(const uint32_t (&tab)[WORDS], uint32_t sym, int size) {
  const uint32_t s4 = sym * 0x01010101u;
  int idx = -1;
#pragma unroll
  for (int w = 0; w < WORDS; ++w) {
    const uint32_t d = tab[w] ^ s4;
    const uint32_t z = (d - 0x01010101u) & ~d & 0x80808080u & low_bytes(clamp4(size - 4 * w));
    if (idx < 0 && z) idx = 4 * w + ((__ffs(z) - 1) >> 3);
  }
  return idx;
}

// The table after coding sym (hit at idx, or a miss), as ase_ops._update:
// entries start..place-1 take their successor, entry place takes sym. A
// place of -1 (a hit in an empty table, only from a corrupt container)
// changes nothing.
__device__ __forceinline__ void update(uint32_t (&tab)[WORDS], int& size, uint32_t sym, bool hit,
                                       int idx) {
  const bool full = size >= TABLE;
  const int start = hit ? idx : full ? 0 : size;
  const int place = hit ? size - 1 : full ? TABLE - 1 : size;
  const uint32_t s4 = sym * 0x01010101u;
#pragma unroll
  for (int w = 0; w < WORDS; ++w) {
    const uint32_t nxt = w + 1 < WORDS ? tab[w + 1] : 0u;
    const uint32_t shifted = __funnelshift_r(tab[w], nxt, 8);
    const uint32_t ms = low_bytes(clamp4(place - 4 * w)) & ~low_bytes(clamp4(start - 4 * w));
    const uint32_t mp = (place >= 0 && (place >> 2) == w) ? 0xFFu << (8 * (place & 3)) : 0u;
    tab[w] = (tab[w] & ~(ms | mp)) | (shifted & ms) | (s4 & mp);
  }
  if (!hit && !full) ++size;
}

// ------------------------------------------------------------- kernel S

// x [stride, K] u8; lane_len [K] i32; scratch [cap, K] u16 (word m of lane
// i at m*K + i); counts [K] its word counts; bits [K] its bit counts.
__global__ void __launch_bounds__(THREADS)
    ase_encode_kernel(const uint8_t* __restrict__ x, const int32_t* __restrict__ lane_len,
                      uint16_t* __restrict__ scratch, int32_t* __restrict__ counts,
                      uint32_t* __restrict__ bits_out, int K, int stride) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= K) return;
  const int len = min(max(lane_len[lane], 0), stride);
  uint32_t tab[WORDS];
#pragma unroll
  for (int w = 0; w < WORDS; ++w) tab[w] = 0;
  int size = 0, bits = 0;
  uint32_t acc = 0, nb = 0, total = 0;
  size_t m = 0;
  uint32_t nxt = len > 0 ? x[lane] : 0u;
  for (int t = 0; t < len; ++t) {
    const uint32_t sym = nxt;
    nxt = t + 1 < len ? x[(size_t)(t + 1) * K + lane] : 0u;
    const int idx = find(tab, sym, size);
    const bool hit = idx >= 0;
    const uint32_t val = hit ? ((uint32_t)(size - 1 - idx) << 1) | 1u : sym << 1;
    const uint32_t width = hit ? (uint32_t)bits + 1u : 9u;
    if (!hit && size < TABLE) bits = 32 - __clz(size);
    update(tab, size, sym, hit, idx);
    acc |= val << nb;
    nb += width;
    total += width;
    if (nb >= 16) {
      scratch[m * K + lane] = (uint16_t)acc;
      ++m;
      acc >>= 16;
      nb -= 16;
    }
  }
  if (nb > 0) {
    scratch[m * K + lane] = (uint16_t)acc;
    ++m;
  }
  counts[lane] = (int32_t)m;
  bits_out[lane] = total;
}

// One CTA: offsets[i] = counts[0] + ... + counts[i - 1], each thread a run
// of consecutive lanes.
__global__ void __launch_bounds__(SCAN_THREADS)
    ase_scan_kernel(const int32_t* __restrict__ counts, int32_t* __restrict__ offsets, int K) {
  __shared__ int32_t warp_sum[SCAN_THREADS / 32];
  const int tid = threadIdx.x, ln = tid & 31, wp = tid >> 5;
  const int per = (K + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min(tid * per, K), hi = min(lo + per, K);
  int32_t s = 0;
  for (int i = lo; i < hi; ++i) s += counts[i];
  int32_t incl = s;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (ln >= d) incl += y;
  }
  if (ln == 31) warp_sum[wp] = incl;
  __syncthreads();
  if (wp == 0) {
    int32_t v = warp_sum[ln], vi = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(0xFFFFFFFFu, vi, d);
      if (ln >= d) vi += y;
    }
    warp_sum[ln] = vi - v;
  }
  __syncthreads();
  int32_t off = warp_sum[wp] + incl - s;
  for (int i = lo; i < hi; ++i) {
    offsets[i] = off;
    off += counts[i];
  }
}

// A warp a lane: its words from the padded area to out[offsets[i] + m].
__global__ void __launch_bounds__(COPY_WARPS * 32)
    ase_copy_kernel(const uint16_t* __restrict__ scratch, const int32_t* __restrict__ counts,
                    const int32_t* __restrict__ offsets, uint16_t* __restrict__ out, int K) {
  const int i = blockIdx.x * COPY_WARPS + (threadIdx.x >> 5);
  if (i >= K) return;
  const int cnt = counts[i], off = offsets[i];
  for (int m = threadIdx.x & 31; m < cnt; m += 32) out[off + m] = scratch[(size_t)m * K + i];
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
constexpr uint32_t FULL = 0xFFFFFFFFu;

// Entry idx (0..63) of the quad's table; every thread of the quad calls it
// with the same idx (and every thread of the warp calls it).
__device__ __forceinline__ uint32_t quad_entry(const uint32_t (&tab)[QWORDS], int idx) {
  const int w = (idx >> 2) & (QWORDS - 1);
  const uint32_t v = w == 0 ? tab[0] : w == 1 ? tab[1] : w == 2 ? tab[2] : tab[3];
  return __shfl_sync(FULL, (v >> (8 * (idx & 3))) & 0xFFu, idx >> 4, QUAD);
}

// update() on the quad's table: thread q moves its words 4q..4q+3 (every
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
// lanes' words lane after lane, zero past them), bits [K]; scratch [K*cap]
// u16, counts and offsets [K] i32 beside them. K a power of two up to
// 65,536, cap = ceil(9*stride / 16), K*cap < 2^31.
extern "C" int ct_ase_encode(const void* x, const void* lane_len, void* scratch, void* counts,
                             void* offsets, void* bits, void* payload, int K, int stride, int cap,
                             void* stream) {
  if (K < 1 || K > 65536 || (K & (K - 1)) || stride < 0 || cap < 0 ||
      (long long)K * cap >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int threads = K < THREADS ? K : THREADS;
  ase_encode_kernel<<<(K + threads - 1) / threads, threads, 0, st>>>(
      (const uint8_t*)x, (const int32_t*)lane_len, (uint16_t*)scratch, (int32_t*)counts,
      (uint32_t*)bits, K, stride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ase_scan_kernel<<<1, SCAN_THREADS, 0, st>>>((const int32_t*)counts, (int32_t*)offsets, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = cudaMemsetAsync(payload, 0, (size_t)K * cap * 2, st)) != cudaSuccess) return (int)err;
  ase_copy_kernel<<<(K + COPY_WARPS - 1) / COPY_WARPS, COPY_WARPS * 32, 0, st>>>(
      (const uint16_t*)scratch, (const int32_t*)counts, (const int32_t*)offsets,
      (uint16_t*)payload, K);
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
