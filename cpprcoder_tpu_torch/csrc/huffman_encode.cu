// Kernel H: CT-HUF1 (canonical Huffman) encode on Hopper.
//
// Replaces the Pallas kernel cpprcoder_tpu/ops/huffman_pallas.py:79
// `_encode_kernel` (pallas_call at huffman_pallas.py:143), together with
// what its call does around it: the lane-major layout and cumsum after the
// kernel (huffman_pallas.py:171-185) and the compaction of the emitted
// words (rans_ops._stream_fn).
//
// What it computes: K interleaved lanes (lane i codes x[j*K + i] at step
// j < lane_len[i]) against one static table of (length <= 15, LSB-first
// code). Lane i's bits are its codes in step order, bits[i] of them; it
// takes counts[i] = ceil(bits[i] / 16) u16 words; woff = the exclusive
// cumsum of counts. The payload is one LSB-first bit string in u32 words
// (little-endian, so its bytes are the container's u16 words): lane i's
// bits start at bit 16 * woff[i], and every other bit is 0. Those are the
// bytes the container stores after its bit counts. A table entry is taken
// as (min(max(len, 0), 15), code & (2^len - 1)), which leaves the tables
// the encoder builds as they are and keeps any table inside the buffer.
//
// Design: the table is static, so a step hands the next one only its bit
// position, which is a prefix sum of code lengths. A lane is cut into
// chunks of CHUNK steps, and every chunk of every lane is coded by its own
// thread, in three launches:
//  1. lengths: a block stages a tile of x (TILE consecutive bytes when
//     K <= THREADS, else TILE / kb rows of kb lanes) in shared memory with
//     16-byte loads, coalesced whatever K is; each thread sums the code
//     lengths of its chunk (steps j < lane_len only: pad bytes are byte 0,
//     whose code may be non-empty) from a 256-entry table in shared memory
//     and writes the sum, lane-major (chunk c of lane i at i * nch + c).
//     The blocks also zero the payload buffer between them (no memset
//     launch).
//  2. scan: blocks of whole lanes scan their chunk sums in place, each lane
//     a segment, SCAN_ITEMS consecutive sums a thread in registers (a
//     warp's shuffles, then the warps' totals through shared memory, the
//     next round's sums loading meanwhile); a lane's total is bits[i].
//     The last block to finish (a ticket in the word past the payload,
//     zeroed with it) scans ceil(bits / 16) across the lanes into woff and
//     counts: K <= 65,536, one block.
//  3. pack: the tile again; each thread ORs its codes into a 64-bit
//     register at its chunk's bit (16 * woff[i] + the chunk's offset) and
//     ORs each u32 word into the zeroed buffer as it fills (atomicOr, a
//     reduction that does not wait: a chunk's first and last words are
//     shared with the chunk or lane before or after it; the words between
//     could be plain stores, which measured no faster). The ORs touch
//     disjoint bits, so every run writes the same payload; a lane's flush
//     word and its padding to 16 bits fall out without a special case.
// Each thread issues the loads of its lane's length (and, packing, its
// offsets) before the block loads its tile, so their latencies overlap.
// Where the Pallas kernel walked each lane's steps in order (a one-hot MXU
// read of the table, a select ladder for the shift, a [stride, K] event a
// step) and a compaction followed, this writes the container's payload
// bits once.
//
// What bounds it: bytes, x read once and the payload (about 15/32 of x on
// text) written once; kennedy.xls: about 1.5 MB, 0.45 us at 3.35 TB/s. The
// tile is read twice (the second time mostly from L2) and the chunk sums
// (4 bytes every CHUNK steps) go through L2 three times. In fact each
// launch is a short chain of global round trips, so the three take about
// 14 us at any size up to a megabyte on an H100 (3 to 6 us each; the scan,
// the longest, one round of 2,048 sums a block plus the last block's).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 16;                // steps of one lane a thread codes
constexpr int TILE = 4096;               // bytes of x a block stages
constexpr int THREADS = TILE / CHUNK;    // a thread a chunk of the tile
constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = 8;            // chunk sums a scan thread takes at a time
constexpr int SCAN_ROUND = SCAN_THREADS * SCAN_ITEMS;
constexpr int MAX_BITS = 15;
constexpr unsigned FULL = 0xFFFFFFFFu;

// The launch geometry, computed by the wrapper (ops/huffman_kernels.py
// encode_geometry) and checked by the entry point: kb lanes and tsteps
// steps a tile (kb * tsteps = TILE), nch chunks a lane.
struct Geo {
  int K, stride, kb, tsteps, nch;
};

__device__ __forceinline__ void load_table(uint32_t* lc, const int32_t* __restrict__ tab) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    const int l = min(max(tab[i], 0), MAX_BITS);
    lc[i] = (uint32_t)l << 16 | ((uint32_t)tab[256 + i] & ((1u << l) - 1u));
  }
}

// Rows [r0, r0 + tsteps) of lanes [k0, k0 + kb) of x into tile [row][kb];
// rows past stride are left as they are (no chunk reads them).
__device__ __forceinline__ void load_tile(uint8_t* tile, const uint8_t* __restrict__ x,
                                          const Geo& g, int r0, int k0) {
  const int rows = min(g.tsteps, g.stride - r0);
  if (g.kb == g.K) {
    // rows * K consecutive bytes; r0 * K is a multiple of TILE, so aligned
    const uint8_t* src = x + (size_t)r0 * g.K;
    const int bytes = rows * g.K, vec = bytes >> 4;
    for (int q = threadIdx.x; q < vec; q += THREADS)
      reinterpret_cast<uint4*>(tile)[q] = __ldg(reinterpret_cast<const uint4*>(src) + q);
    for (int b = (vec << 4) + threadIdx.x; b < bytes; b += THREADS) tile[b] = src[b];
  } else {
    // kb (a multiple of 16) bytes of each row
    const int per_row = g.kb >> 4;
    for (int q = threadIdx.x; q < rows * per_row; q += THREADS) {
      const int row = q / per_row;
      reinterpret_cast<uint4*>(tile)[q] = __ldg(
          reinterpret_cast<const uint4*>(x + (size_t)(r0 + row) * g.K + k0) + (q - row * per_row));
    }
  }
}

// This thread's chunk: lane k0 + l, steps [s0, s0 + CHUNK) (none when
// s0 >= stride); `at` its index in the lane-major chunk arrays.
struct Chunk {
  int lane, s0, tcol;  // tcol: its first symbol's offset in the tile
  size_t at;
  bool mine;
};

__device__ __forceinline__ Chunk my_chunk(const Geo& g) {
  Chunk ch;
  const int l = threadIdx.x % g.kb, c = threadIdx.x / g.kb;
  ch.s0 = blockIdx.x * g.tsteps + c * CHUNK;
  ch.mine = ch.s0 < g.stride;
  ch.lane = blockIdx.y * g.kb + l;
  ch.tcol = c * CHUNK * g.kb + l;
  ch.at = (size_t)ch.lane * g.nch + ch.s0 / CHUNK;
  return ch;
}

// The steps of the chunk to code, from its lane's length (<= 0: none).
__device__ __forceinline__ int active_steps(const Chunk& ch, int len, const Geo& g) {
  return min(min(len, g.stride) - ch.s0, CHUNK);
}

// x [stride, K] u8; lane_len [K] i32; tab [2, 256] i32 (lengths, codes);
// sums [K * nch] u32: each chunk's code bits, lane-major; zero [nzero]
// u32: set to 0 by the blocks between them.
__global__ void __launch_bounds__(THREADS) huffman_lengths_kernel(
    const uint8_t* __restrict__ x, const int32_t* __restrict__ lane_len,
    const int32_t* __restrict__ tab, uint32_t* __restrict__ sums, uint32_t* __restrict__ zero,
    size_t nzero, Geo g) {
  __shared__ uint32_t lc[256];
  __shared__ __align__(16) uint8_t tile[TILE];
  const Chunk ch = my_chunk(g);
  const int len = ch.mine ? lane_len[ch.lane] : 0;
  const size_t block = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const size_t nthreads = (size_t)gridDim.x * gridDim.y * THREADS;
  for (size_t q = block * THREADS + threadIdx.x; q < nzero / 4; q += nthreads)
    reinterpret_cast<uint4*>(zero)[q] = make_uint4(0, 0, 0, 0);
  if (block == 0 && threadIdx.x < (nzero & 3)) zero[(nzero & ~(size_t)3) + threadIdx.x] = 0;
  load_table(lc, tab);
  load_tile(tile, x, g, blockIdx.x * g.tsteps, blockIdx.y * g.kb);
  __syncthreads();
  if (!ch.mine) return;
  const int active = active_steps(ch, len, g);
  const uint8_t* col = tile + ch.tcol;
  uint32_t sum = 0;
#pragma unroll
  for (int s = 0; s < CHUNK; ++s) sum += s < active ? lc[col[s * g.kb]] >> 16 : 0u;
  sums[ch.at] = sum;
}

// A segmented sum: `head` when a segment starts in the span, `sum` the
// span's sum since its last segment start (all of it if none).
struct Seg {
  uint32_t head, sum;
};

__device__ __forceinline__ Seg combine(Seg a, Seg b) {
  return {a.head | b.head, b.head ? b.sum : a.sum + b.sum};
}

// The exclusive scan of in(e) over [begin, end) in segments that start at
// every multiple of seg (begin is one), SCAN_ROUND at a time, each thread
// holding SCAN_ITEMS consecutive elements in registers: out(e, the sum of
// its segment before e, in(e)), and at each segment's last element
// on_end(e, the segment's total). The next round's elements are loaded
// while this one is scanned; wpart holds a Seg a warp for two rounds.
template <class In, class Out, class End>
__device__ void seg_scan(size_t begin, size_t end, size_t seg, In in, Out out, End on_end,
                         Seg (*wpart)[SCAN_THREADS / 32]) {
  constexpr int NW = SCAN_THREADS / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t next[SCAN_ITEMS];
  auto fetch = [&](size_t base) {
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      const size_t e = base + tid * SCAN_ITEMS + k;
      next[k] = e < end ? in(e) : 0u;
    }
  };
  fetch(begin);
  uint32_t carry = 0;  // the running sum entering the round
  int round = 0;
  for (size_t base = begin; base < end; base += SCAN_ROUND, round ^= 1) {
    uint32_t v[SCAN_ITEMS];
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) v[k] = next[k];
    if (base + SCAN_ROUND < end) fetch(base + SCAN_ROUND);
    const size_t e0 = base + tid * SCAN_ITEMS;
    const size_t pos0 = e0 % seg;
    Seg mine = {0, 0};
    size_t pos = pos0;
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      if (pos == 0) mine = {1, 0};
      mine.sum += v[k];
      pos = pos + 1 == seg ? 0 : pos + 1;
    }
    Seg inc = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Seg up = {__shfl_up_sync(FULL, inc.head, d), __shfl_up_sync(FULL, inc.sum, d)};
      if (lane >= d) inc = combine(up, inc);
    }
    const Seg before = {__shfl_up_sync(FULL, inc.head, 1), __shfl_up_sync(FULL, inc.sum, 1)};
    Seg* wp = wpart[round];
    if (lane == 31) wp[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      Seg w = lane < NW ? wp[lane] : Seg{0, 0};
#pragma unroll
      for (int d = 1; d < NW; d <<= 1) {
        const Seg up = {__shfl_up_sync(FULL, w.head, d), __shfl_up_sync(FULL, w.sum, d)};
        if (lane >= d) w = combine(up, w);
      }
      if (lane < NW) wp[lane] = w;
    }
    __syncthreads();
    Seg pre = {0, carry};
    if (warp > 0) pre = combine(pre, wp[warp - 1]);
    if (lane > 0) pre = combine(pre, before);
    carry = combine(Seg{0, carry}, wp[NW - 1]).sum;
    uint32_t run = pre.sum;
    pos = pos0;
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      if (pos == 0) run = 0;
      if (e0 + k < end) {
        out(e0 + k, run, v[k]);
        if (pos + 1 == seg) on_end(e0 + k, run + v[k]);
      }
      run += v[k];
      pos = pos + 1 == seg ? 0 : pos + 1;
    }
  }
}

// sums [K * nch] u32 -> each chunk's bit offset in its lane, in place;
// bits [K]; then, in the last block, counts [K] = ceil(bits / 16) and woff
// [K] their exclusive cumsum. ticket: 0 before the launch.
__global__ void __launch_bounds__(SCAN_THREADS) huffman_scan_kernel(
    uint32_t* __restrict__ sums, uint32_t* __restrict__ bits, uint32_t* __restrict__ counts,
    uint32_t* __restrict__ woff, uint32_t* __restrict__ ticket, int K, int nch, int scan_lanes) {
  __shared__ Seg wpart[2][SCAN_THREADS / 32];
  __shared__ bool last;
  const size_t lane0 = (size_t)blockIdx.x * scan_lanes;
  const size_t lane1 = min(lane0 + scan_lanes, (size_t)K);
  seg_scan(
      lane0 * nch, lane1 * nch, (size_t)nch, [&](size_t e) { return sums[e]; },
      [&](size_t e, uint32_t ex, uint32_t) { sums[e] = ex; },
      [&](size_t e, uint32_t total) { bits[e / nch] = total; }, wpart);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  seg_scan(
      0, (size_t)K, (size_t)K, [&](size_t e) { return (__ldcg(bits + e) + 15u) >> 4; },
      [&](size_t e, uint32_t ex, uint32_t v) {
        woff[e] = ex;
        counts[e] = v;
      },
      [](size_t, uint32_t) {}, wpart);
}

// offs [K * nch]: each chunk's bit offset in its lane; woff [K]; payload:
// u32 words, zero before the launch.
__global__ void __launch_bounds__(THREADS) huffman_pack_kernel(
    const uint8_t* __restrict__ x, const int32_t* __restrict__ lane_len,
    const int32_t* __restrict__ tab, const uint32_t* __restrict__ offs,
    const uint32_t* __restrict__ woff, uint32_t* __restrict__ payload, Geo g) {
  __shared__ uint32_t lc[256];
  __shared__ __align__(16) uint8_t tile[TILE];
  const Chunk ch = my_chunk(g);
  const int len = ch.mine ? lane_len[ch.lane] : 0;
  const uint64_t b0 = ch.mine ? 16ull * woff[ch.lane] + offs[ch.at] : 0;
  load_table(lc, tab);
  load_tile(tile, x, g, blockIdx.x * g.tsteps, blockIdx.y * g.kb);
  __syncthreads();
  if (!ch.mine) return;
  const int active = active_steps(ch, len, g);
  const uint8_t* col = tile + ch.tcol;
  uint32_t* w = payload + (b0 >> 5);
  uint32_t nb = (uint32_t)b0 & 31u;  // acc's bit 0 is bit 0 of *w
  uint32_t lo = nb;                  // *w's bits below lo are not this chunk's
  uint64_t acc = 0;
#pragma unroll
  for (int s = 0; s < CHUNK; ++s) {
    if (s < active) {
      const uint32_t e = lc[col[s * g.kb]];
      acc |= (uint64_t)(e & 0xFFFFu) << nb;
      nb += e >> 16;
      if (nb >= 32) {
        atomicOr(w, (uint32_t)acc);
        ++w;
        lo = 0;
        acc >>= 32;
        nb -= 32;
      }
    }
  }
  if (nb > lo) atomicOr(w, (uint32_t)acc);
}

}  // namespace

// x [stride, K] u8 and payload (16-byte aligned), lane_len [K] i32, tab
// [2, 256] i32; scratch [K * nch + K] u32 (chunk sums, woff); payload
// [payload_words + 1] u32 (the last word the scan's ticket); counts, bits
// [K] i32. The geometry
// (kb, tsteps, nch, tiles, scan_lanes, scan_blocks) is the wrapper's;
// a geometry that does not cover every step of every lane with this
// source's CHUNK and TILE is refused with cudaErrorInvalidValue.
extern "C" int ct_huffman_encode_stream(const void* x, const void* lane_len, const void* tab,
                                        void* scratch, void* payload, void* counts, void* bits,
                                        int K, int stride, int kb, int tsteps, int nch, int tiles,
                                        int scan_lanes, int scan_blocks, int payload_words,
                                        void* stream) {
  const bool ok = K > 0 && stride > 0 && kb > 0 && K % kb == 0 && kb * tsteps == TILE &&
                  tsteps % CHUNK == 0 && (kb == K || kb % 16 == 0) &&
                  (long long)nch * CHUNK >= stride && (long long)(nch - 1) * CHUNK < stride &&
                  (long long)tiles * tsteps >= stride && (long long)(tiles - 1) * tsteps < stride &&
                  scan_lanes > 0 && (long long)scan_blocks * scan_lanes >= K &&
                  (long long)(scan_blocks - 1) * scan_lanes < K && payload_words > 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  uint32_t* pw = (uint32_t*)payload;
  uint32_t* sums = (uint32_t*)scratch;
  uint32_t* woff = sums + (size_t)K * nch;
  const Geo g = {K, stride, kb, tsteps, nch};
  const dim3 grid(tiles, K / kb);
  huffman_lengths_kernel<<<grid, THREADS, 0, st>>>((const uint8_t*)x, (const int32_t*)lane_len,
                                                   (const int32_t*)tab, sums, pw,
                                                   (size_t)payload_words + 1, g);
  huffman_scan_kernel<<<scan_blocks, SCAN_THREADS, 0, st>>>(
      sums, (uint32_t*)bits, (uint32_t*)counts, woff, pw + payload_words, K, nch, scan_lanes);
  huffman_pack_kernel<<<grid, THREADS, 0, st>>>((const uint8_t*)x, (const int32_t*)lane_len,
                                                (const int32_t*)tab, sums, woff, pw, g);
  return (int)cudaGetLastError();
}
