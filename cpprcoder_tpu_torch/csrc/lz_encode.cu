// Kernels P and Q: the CT-LZ4 (SLZ4) v2 encode's parse walk (P) and token
// serializer (Q), on Hopper.
//
// They replace no Pallas kernel: the JAX package runs these steps as XLA
// code shaped by Mosaic's limits (cpprcoder_tpu/ops/lz_ops.py):
//   - P: `_greedy_membership` (:644-692), per-128-position jump tables built
//     by one-hot MXU dots, one lax.scan across the blocks and an orbit
//     doubling inside them, then the sort that lists the matches (:730-742);
//   - Q: the byte-exact clamp (:716-728, cummax/cummin propagation) and
//     `_serialize_fn_v2` (:396-500, a scatter and a packed cummax that give
//     every output byte its token; the packing wraps past 2^18 tokens, C1).
// The spec is reference/slz4_ref.py (`parse_segment_v2`, `serialize_tokens`).
//
// P. Segment i's walk goes from position 0 to p + step[p] (step >= 1; a
// position with step > 1 is a match, of length step) until it passes W.
// The chain is serial, so it is cut into blocks of B positions (128 up to
// W = 2^17, else W / 1024 rounded up: at most 1024 blocks), one thread a
// block, one CTA a segment:
//   1. each thread scans its block backwards: exit[p] = the first position
//      at or past the block's end that the walk from p reaches (p + step[p]
//      if that leaves the block, else exit[p + step[p]]; a literal reuses
//      the exit of p + 1 from a register);
//   2. thread 0 hops from 0 along the exits, one per block at most, and
//      records where the walk enters each block;
//   3. each thread walks its block from its entry and counts its matches; a
//      scan of the counts gives each block its first output slot, and a
//      second walk writes (position, length, offset) there.
// Bound: bytes (step and off read, the matches written). What holds it
// back: the dependent loads of the scan and of thread 0's hops (at most
// 1024 a segment), and one CTA a segment.
//
// Q. Two launches, no host read and no cumsum between them (a first design
// had three, a cumsum and two host reads, int(count.max()) to size a grid
// and int(ends[-1]) to size the payload, which set a floor of 0.15-0.2 ms
// at any shape):
//   1. size_kernel, a CTA a segment (its row in shared memory where it
//      fits): every match starts at its walk length, each thread compares
//      the positions of its share of the row that matches cover with their
//      sources and lowers a match's length to its first mismatch
//      (atomicMin), so a long match is clamped by many threads; then a
//      thread a run of consecutive tokens sizes them (token t's literals run
//      from match t - 1's clamped end to match t, the last token's to the
//      segment's length: the header byte, the 255-runs of both lengths, the
//      literals, the u16 offset) and a CTA scan gives each token its start
//      in the segment's block and the block's size;
//   2. place_kernel, a CTA a 4,096-byte chunk of a segment's worst-case
//      block (w + w/255 + 16 bytes: ops/lz_kernels.py payload_bound): the
//      CTA sums the blocks' sizes before its segment (its base in the
//      payload) and all of them (the total), each thread writes 16
//      consecutive bytes of the block (its token by a binary search of the
//      starts) and zeroes its share of the payload past the total.
// The payload is n * (w + w/255 + 16) bytes, its blocks at their exact
// offsets. Bound: bytes (the input read once, the payload written once).
// What holds it back: one CTA a segment in launch 1, and each CTA of
// launch 2 reading all n sizes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lz_common.cuh"

namespace {

constexpr int WALK_BLOCK = 128;    // positions a block up to W = 2^17
constexpr int MAX_BLOCKS = 1024;   // blocks a segment: a thread each
constexpr int MIN_MATCH = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr int Q_MAX_THREADS = 1024;     // Q's first launch: a CTA a segment
constexpr int Q_SMEM_MAX = 220 * 1024;  // the most dynamic shared memory launch 1 takes
constexpr int PLACE_THREADS = 256;      // Q's second launch
constexpr int PLACE_BYTES = 16;         // payload bytes a thread
constexpr int CHUNK = PLACE_THREADS * PLACE_BYTES;

__global__ void __launch_bounds__(MAX_BLOCKS)
walk_kernel(const int32_t* __restrict__ step, const int32_t* __restrict__ off,
            int32_t* exits, int32_t* __restrict__ mpos, int32_t* __restrict__ mlen,
            int32_t* __restrict__ moff, int32_t* __restrict__ count, int w, int blen,
            int nb, int tcap) {
  __shared__ int entry[MAX_BLOCKS];
  __shared__ int warp_sum[32];
  const long long row = (long long)blockIdx.x * w;
  const int32_t* st = step + row;
  int32_t* ex = exits + row;
  const int b = threadIdx.x;
  const int lo = b * blen;
  const int hi = b < nb ? min(lo + blen, w) : 0;
  if (b < nb) {
    entry[b] = -1;
    int last = 0;   // exit[p + 1]
    for (int p = hi - 1; p >= lo; --p) {
      const int nx = p + st[p];
      const int e = nx >= hi ? nx : (nx == p + 1 ? last : ex[nx]);
      ex[p] = e;
      last = e;
    }
  }
  __syncthreads();
  if (b == 0) {
    for (int p = 0; p < w; p = ex[p]) entry[p / blen] = p;
  }
  __syncthreads();
  const int e0 = b < nb ? entry[b] : -1;
  int c = 0;
  if (e0 >= 0) {
    for (int p = e0; p < hi;) {
      const int s = st[p];
      c += s > 1;
      p += s;
    }
  }
  // exclusive scan of the counts over the CTA
  const int lane = b & 31, wid = b >> 5, nw = blockDim.x >> 5;
  int v = c;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += t;
  }
  if (lane == 31) warp_sum[wid] = v;
  __syncthreads();
  if (wid == 0) {
    int t = lane < nw ? warp_sum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, t, o);
      if (lane >= o) t += u;
    }
    warp_sum[lane] = t;
  }
  __syncthreads();
  int k = v - c + (wid > 0 ? warp_sum[wid - 1] : 0);
  if (e0 >= 0) {
    const long long orow = (long long)blockIdx.x * tcap;
    for (int p = e0; p < hi;) {
      const int s = st[p];
      if (s > 1) {
        mpos[orow + k] = p;
        mlen[orow + k] = s;
        moff[orow + k] = off[row + p];
        ++k;
      }
      p += s;
    }
  }
  if (b == 0) count[blockIdx.x] = warp_sum[nw - 1];
}

__device__ __forceinline__ int ext_len(int v) { return v >= 15 ? (v - 15) / 255 + 1 : 0; }

struct Token {
  int ls, ll, m, off;   // literal start, literal length, match length, offset
};

// Token t of a segment with c matches (t == c: the last, literals only).
// clamped is read past L1: the clamp launch writes it with atomics.
__device__ __forceinline__ Token token_at(const int32_t* mpos, const int32_t* clamped,
                                          const int32_t* moff, long long rowk, int t, int c,
                                          int len) {
  Token tk;
  tk.ls = t == 0 ? 0 : mpos[rowk + t - 1] + __ldcg(clamped + rowk + t - 1);
  const bool last = t == c;
  tk.ll = (last ? len : mpos[rowk + t]) - tk.ls;
  tk.m = last ? 0 : __ldcg(clamped + rowk + t);
  tk.off = last ? 0 : moff[rowk + t];
  return tk;
}

__device__ __forceinline__ int token_size(const Token& tk) {
  return 1 + ext_len(tk.ll) + tk.ll + (tk.m > 0 ? 2 + ext_len(tk.m - MIN_MATCH) : 0);
}

// Byte u of token tk's serialization (x: the segment's bytes).
__device__ __forceinline__ uint8_t token_byte(const Token& tk, const uint8_t* x, int u) {
  const int el = ext_len(tk.ll), mx = tk.m - MIN_MATCH;
  if (u == 0) return (uint8_t)((min(tk.ll, 15) << 4) | (tk.m > 0 ? min(mx, 15) : 0));
  if (u < 1 + el) {
    const int lrem = tk.ll - 15;
    return (uint8_t)(u - 1 < lrem / 255 ? 255 : lrem % 255);
  }
  if (u < 1 + el + tk.ll) return x[tk.ls + u - 1 - el];
  const int o = u - 1 - el - tk.ll;
  if (o == 0) return (uint8_t)(tk.off & 255);
  if (o == 1) return (uint8_t)(tk.off >> 8);
  const int mrem = mx - 15;
  return (uint8_t)(o - 2 < mrem / 255 ? 255 : mrem % 255);
}

// Exclusive scan of v over the CTA (blockDim.x a multiple of 32) -> (its
// exclusive prefix, the CTA's total).
__device__ int2 cta_scan(int v, int* warp_sum) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += u;
  }
  if (lane == 31) warp_sum[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int y = lane < nw ? warp_sum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, y, o);
      if (lane >= o) y += u;
    }
    warp_sum[lane] = y;
  }
  __syncthreads();
  return make_int2(x - v + (wid > 0 ? warp_sum[wid - 1] : 0), warp_sum[nw - 1]);
}

// Q, launch 1, one segment: the clamp, then the sizes and their scan. x:
// the row; pos, cl: the matches' positions and their clamped lengths (in
// shared memory with SMEM, where cl starts as the walk's lengths; else
// global, cl already the walk's lengths and read past L1).
template <bool SMEM>
__device__ __forceinline__ void size_segment(const uint8_t* x, const int32_t* pos, int32_t* cl,
                                             const int32_t* __restrict__ moff, int32_t* ts,
                                             int32_t* sz, int c, int w, int len, int& total,
                                             int* warp_sum) {
  const int tid = threadIdx.x, nt = blockDim.x;
  auto clamp_of = [&](int t) { return SMEM ? cl[t] : __ldcg(cl + t); };
  // a share of 4 * odd positions: the lanes' bytes in step on 32 banks
  const int per = ((w + nt - 1) / nt + 3) / 4 * 4 | 4;
  const int a = (int)min((long long)tid * per, (long long)w), z = min(a + per, w);
  if (a < z && c > 0) {
    int lo = 0, hi = c - 1;   // the last match starting at or before a (or 0)
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (pos[mid] <= a) lo = mid;
      else hi = mid - 1;
    }
    int o_next = moff[lo];   // a match's offset loaded a match ahead
    for (int t = lo; t < c; ++t) {
      const int p = pos[t];
      if (p >= z) break;
      const int o = o_next;
      if (t + 1 < c) o_next = moff[t + 1];
      // the match's length so far: its first mismatch is at or before it
      const int e = min(z, p + clamp_of(t));
      for (int q = max(a, p); q < e; ++q) {
        if (x[q] != x[q - o]) {
          atomicMin(cl + t, q - p);
          break;
        }
      }
    }
  }
  __syncthreads();
  // each token's size into sz (a match's end carried to the next token),
  // then, after the scan, its start into ts
  const int tper = (c + nt) / nt;   // c + 1 tokens
  const int ta = min(tid * tper, c + 1), tz = min(ta + tper, c + 1);
  int sum = 0;
  int ls = ta == 0 ? 0 : pos[ta - 1] + clamp_of(ta - 1);
  for (int t = ta; t < tz; ++t) {
    Token tk;
    tk.ls = ls;
    tk.m = t == c ? 0 : clamp_of(t);
    const int p = t == c ? len : pos[t];
    tk.ll = p - ls;
    ls = p + tk.m;
    const int s = token_size(tk);
    sz[t] = s;
    sum += s;
  }
  const int2 sc = cta_scan(sum, warp_sum);
  int at = sc.x;
  for (int t = ta; t < tz; ++t) {
    const int s = sz[t];
    ts[t] = at;
    at += s;
  }
  total = sc.y;
}

// Q, launch 1: one CTA a segment. The row, and the matches' positions and
// lengths, are staged in shared memory where they fit (else read in
// place). Every match starts at its unclamped length; each thread compares
// the positions [a, z) of its share that matches cover with their sources,
// and takes the first mismatch of each match to its clamped length
// (atomicMin). Then a thread a run of consecutive tokens sizes them; a CTA
// scan gives each token its start in the segment's block and the block's
// size.
__global__ void __launch_bounds__(Q_MAX_THREADS)
size_kernel(const uint8_t* __restrict__ rows, const int32_t* __restrict__ mpos,
            const int32_t* __restrict__ mlen, const int32_t* __restrict__ moff,
            const int32_t* __restrict__ count, const long long* __restrict__ lens,
            int32_t* clamped, int32_t* __restrict__ tstart, long long* __restrict__ seg_size, int w,
            int tcap, int smem_bytes) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int warp_sum[32];
  const int seg = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const long long k0 = (long long)seg * tcap;
  const int c = count[seg], len = (int)lens[seg];
  const int w16 = (w + 31) & ~15;   // the row, then (after the clamp) c + 1 <= w / 4 + 2 sizes
  const uint8_t* x = rows + (long long)seg * w;
  int32_t* ts = tstart + (long long)seg * (tcap + 1);
  int total;
  const int c4 = (c + 3) & ~3;
  if (w16 + 8LL * c4 <= smem_bytes) {
    int32_t* pos = reinterpret_cast<int32_t*>(smem + w16);
    int32_t* cl = pos + c4;
    ct::stage(smem, x, w);
    ct::stage(reinterpret_cast<uint8_t*>(pos), reinterpret_cast<const uint8_t*>(mpos + k0),
              4 * c);
    ct::stage(reinterpret_cast<uint8_t*>(cl), reinterpret_cast<const uint8_t*>(mlen + k0),
              4 * c);
    __syncthreads();
    size_segment<true>(smem, pos, cl, moff + k0, ts, reinterpret_cast<int32_t*>(smem), c, w,
                       len, total, warp_sum);
    for (int t = tid; t < c; t += nt) clamped[k0 + t] = cl[t];
  } else {
    const bool staged = w <= smem_bytes;
    if (staged) ct::stage(smem, x, w);
    for (int t = tid; t < c; t += nt) clamped[k0 + t] = mlen[k0 + t];
    __syncthreads();
    size_segment<false>(staged ? smem : x, mpos + k0, clamped + k0, moff + k0, ts, ts, c, w,
                        len, total, warp_sum);
  }
  if (tid == 0) seg_size[seg] = total;
}

// Q, launch 2: a CTA a CHUNK of a segment's block. Its base in the payload
// is the sum of the blocks before it, its total the sum of all (the
// CTA reads the n sizes); each thread writes PLACE_BYTES consecutive bytes
// of the block (its token by a binary search of the starts, then a step
// forward) and zeroes its share of the payload past the total.
__global__ void __launch_bounds__(PLACE_THREADS)
place_kernel(const uint8_t* __restrict__ rows, const int32_t* __restrict__ mpos,
             const int32_t* __restrict__ clamped, const int32_t* __restrict__ moff,
             const int32_t* __restrict__ count, const long long* __restrict__ lens,
             const int32_t* __restrict__ tstart, const long long* __restrict__ seg_size,
             uint8_t* __restrict__ payload, int n, int w, int tcap, int chunks, long long cap) {
  __shared__ long long part[2][PLACE_THREADS / 32];
  const long long blk = blockIdx.x;
  const int seg = (int)(blk / chunks), ch = (int)(blk % chunks);
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  long long before = 0, total = 0;
  for (int i = tid; i < n; i += PLACE_THREADS) {
    const long long z = seg_size[i];
    total += z;
    if (i < seg) before += z;
  }
  for (int o = 16; o > 0; o >>= 1) {
    before += __shfl_down_sync(FULL, before, o);
    total += __shfl_down_sync(FULL, total, o);
  }
  if (lane == 0) {
    part[0][wid] = before;
    part[1][wid] = total;
  }
  __syncthreads();
  before = total = 0;
  for (int k = 0; k < PLACE_THREADS / 32; ++k) {
    before += part[0][k];
    total += part[1][k];
  }
  const long long z0 = total + blk * CHUNK, z1 = min(z0 + CHUNK, cap);
  for (long long q = z0 + tid; q < z1; q += PLACE_THREADS) payload[q] = 0;
  const long long size = seg_size[seg];
  const int u0 = ch * CHUNK + tid * PLACE_BYTES;
  if (u0 >= size) return;
  const int c = count[seg], len = (int)lens[seg];
  const long long k0 = (long long)seg * tcap;
  const int32_t* ts = tstart + (long long)seg * (tcap + 1);
  int lo = 0, hi = c;   // the last token starting at or before u0
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (ts[mid] <= u0) lo = mid;
    else hi = mid - 1;
  }
  int t = lo, start = ts[t];
  Token tk = token_at(mpos, clamped, moff, k0, t, c, len);
  int sz = token_size(tk);
  const uint8_t* x = rows + (long long)seg * w;
  uint8_t* dst = payload + before;
  for (int u = u0; u < u0 + PLACE_BYTES && u < size; ++u) {
    while (u >= start + sz) {
      start += sz;
      tk = token_at(mpos, clamped, moff, k0, ++t, c, len);
      sz = token_size(tk);
    }
    dst[u] = token_byte(tk, x, u - start);
  }
}

}  // namespace

// step, off int32 [n, w] -> mpos, mlen, moff int32 [n, tcap] (zeroed by the
// caller; the walk's matches in order), count int32 [n]; exits int32 [n, w]
// is scratch.
extern "C" int ct_lz_walk(const void* step, const void* off, void* exits, void* mpos, void* mlen,
                          void* moff, void* count, int n, int w, int tcap, void* stream) {
  const int blen = w <= WALK_BLOCK * MAX_BLOCKS ? min(WALK_BLOCK, w)
                                                 : (w + MAX_BLOCKS - 1) / MAX_BLOCKS;
  const int nb = (w + blen - 1) / blen;
  const int threads = (nb + 31) / 32 * 32;
  walk_kernel<<<n, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)step, (const int32_t*)off, (int32_t*)exits, (int32_t*)mpos,
      (int32_t*)mlen, (int32_t*)moff, (int32_t*)count, w, blen, nb, tcap);
  return (int)cudaGetLastError();
}

// rows uint8 [n, w], lens int64 [n] and P's matches -> payload uint8
// [n * (w + w / 255 + 16)] (the segments' blocks in order, zero past them)
// and sizes int64 [n]; clamped int32 [n, tcap] and tstart int32
// [n, tcap + 1] are scratch. Two launches, no host read.
extern "C" int ct_lz_serialize(const void* rows, const void* lens, const void* mpos,
                               const void* mlen, const void* moff, const void* count,
                               void* clamped, void* tstart, void* sizes, void* payload, int n,
                               int w, int tcap, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  // the row and two int32 a match, up to the most shared memory a CTA may use
  const int smem = (int)min((long long)Q_SMEM_MAX, ((w + 31) & ~15) + 8LL * ((tcap + 3) & ~3));
  const cudaError_t e =
      cudaFuncSetAttribute(size_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = (int)min(1024LL, ((long long)w + 1023) / 1024 * 32);
  size_kernel<<<n, threads, smem, st>>>(
      (const uint8_t*)rows, (const int32_t*)mpos, (const int32_t*)mlen, (const int32_t*)moff,
      (const int32_t*)count, (const long long*)lens, (int32_t*)clamped, (int32_t*)tstart,
      (long long*)sizes, w, tcap, smem);
  const long long bound = (long long)w + w / 255 + 16;
  const int chunks = (int)((bound + CHUNK - 1) / CHUNK);
  place_kernel<<<(unsigned)((long long)n * chunks), PLACE_THREADS, 0, st>>>(
      (const uint8_t*)rows, (const int32_t*)mpos, (const int32_t*)clamped, (const int32_t*)moff,
      (const int32_t*)count, (const long long*)lens, (const int32_t*)tstart,
      (const long long*)sizes, (uint8_t*)payload, n, w, tcap, chunks, (long long)n * bound);
  return (int)cudaGetLastError();
}
