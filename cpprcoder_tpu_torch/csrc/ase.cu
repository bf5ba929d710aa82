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
// Design. A thread a lane: lanes share nothing. The table lives in 16
// registers, entry 4w + b in byte b of word w, so that every loop over it
// unrolls to fixed registers (no local memory): the find is a zero-byte test
// of (word ^ sym*0x01010101) a word, masked to the entries in use (entries
// are distinct, so the lowest flagged byte of the lowest flagged word is the
// match: the test's false positives lie only above a true zero byte); the
// update builds each word from itself and the next one shifted down a byte
// (a funnel shift), under byte masks of the moved range and the symbol's
// place. S prefetches its next symbol a step ahead and writes its words to a
// padded word-major area [cap, K]; a one-CTA scan of the word counts gives
// each lane's offset, and a warp a lane copies its words to their place.
//
// What bounds it: each lane's steps are one dependent chain (find, update,
// emit: about 150 integer operations), and at K = 256 (kennedy.xls) only 256
// threads run: the chain's latency, not the card's rate, sets the time.
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

// Entry idx (0..63) of the table.
__device__ __forceinline__ uint32_t entry(const uint32_t (&tab)[WORDS], int idx) {
  uint32_t v = 0;
#pragma unroll
  for (int w = 0; w < WORDS; ++w) v = (idx >> 2) == w ? tab[w] : v;
  return (v >> (8 * (idx & 3))) & 0xFFu;
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

// words [P] u16, lane i's from bases[i], counts[i] of them; out [n] u8,
// out[j*K + i] for j < lane_len[i].
__global__ void __launch_bounds__(THREADS)
    ase_decode_kernel(const uint16_t* __restrict__ words, long long P,
                      const int32_t* __restrict__ bases, const int32_t* __restrict__ counts,
                      const int32_t* __restrict__ lane_len, uint8_t* __restrict__ out, int K,
                      int stride) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= K) return;
  const int len = min(max(lane_len[lane], 0), stride);
  long long cur = bases[lane];
  long long end = cur + (long long)max(counts[lane], 0);
  end = end < P ? end : P;
  uint32_t tab[WORDS];
#pragma unroll
  for (int w = 0; w < WORDS; ++w) tab[w] = 0;
  int size = 0, bits = 0;
  uint32_t win = 0, nb = 0;
  for (int t = 0; t < len; ++t) {
    if (nb <= 16) {
      const uint32_t w = cur >= 0 && cur < end ? (uint32_t)words[cur] : 0u;
      win |= w << nb;
      nb += 16;
      ++cur;
    }
    const bool hit = win & 1u;
    uint32_t sym, used;
    int idx = -1;
    if (hit) {
      const int d = (int)((win >> 1) & ((1u << bits) - 1u));
      idx = max(size - 1 - d, 0);
      sym = entry(tab, idx);
      used = 1u + (uint32_t)bits;
    } else {
      sym = (win >> 1) & 0xFFu;
      used = 9u;
    }
    if (!hit && size < TABLE) bits = 32 - __clz(size);
    update(tab, size, sym, hit, idx);
    win >>= used;
    nb -= used;
    out[(size_t)t * K + lane] = (uint8_t)sym;
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
  const int threads = K < THREADS ? K : THREADS;
  ase_decode_kernel<<<(K + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)words, P, (const int32_t*)bases, (const int32_t*)counts,
      (const int32_t*)lane_len, (uint8_t*)out, K, stride);
  return (int)cudaGetLastError();
}
