// Kernel R: CT-LZ4 (SLZ4) decode, any container (v1 or v2 parse, any
// seg_log2), on Hopper.
//
// It replaces no Pallas kernel: the JAX package decodes with XLA code
// shaped by Mosaic's limits (cpprcoder_tpu/ops/lz_ops.py:756-866,
// `_walk_v2_fn`: each position's next token start, token starts by jump
// tables and one scan; `_resolve_v2_fn`: every output byte's owner by a
// packed cummax, a mod-hop for overlapping matches, match chains by
// pointer doubling under a while_loop; the v1 `_walk_fn` and `_resolve_fn`
// below 2^7-byte segments). It replaces a first design that ran one warp a
// segment, parsing its tokens one after another from a 128-byte window
// (7.086 ms at kennedy.xls, 17,481x its bound, PERF.md). The spec is the
// LZ4 block decoder reference/slz4_ref.py `decode_block`, with the checks
// of ops/lz_kernels.py `_decode_segment`.
//
// Design: tokens found in parallel, one CTA a segment; then the bytes
// resolved in parallel over a grid as wide as the output (all segments).
//   0. next_kernel, a thread a position of every block, over the whole
//      card: next(p), the token start after a token that began at p (the
//      header, the 255-runs of both lengths from the next byte that is not
//      255, the literals, the offset; a check that fails without an output
//      position, or a token past the block, gives the sentinel size + 1).
//   1. token_kernel, a CTA a segment. Shared memory holds a byte of exit a
//      position (exit - its block's end; 255 or more goes to global
//      scratch as int32) and the segment's block, where both fit (a block
//      up to 112 KB), and until the hops are done next() in the block's
//      place where that fits too (up to 45 KB: kennedy.xls's blocks); a
//      larger block keeps int32 exits in global scratch, and a block larger
//      than shared memory (seg_log2 > 17, or a malformed size) is read from
//      global memory in place (a template parameter for the first, a
//      pointer for the rest, one kernel). Thread 0 first
//      follows next() for up to PROBE tokens; a block that ends within them
//      (one literal run, one long match) needs nothing more. Else the
//      positions are cut into blocks of 2^lb + 4 (at least 20; at most 512
//      blocks a segment; the 4 puts each lane's block on its own
//      shared-memory bank), a thread a block, as kernel P's walk
//      (lz_encode.cu):
//        - each thread scans its block backwards: exit[p] = next(p) if that
//          leaves the block, else exit[next(p)];
//        - thread 0 hops on from where its walk stopped along the exits,
//          at most one per block, recording where the walk enters each
//          block.
//      Then each thread re-walks its block from its entry, parsing each
//      token, and counts its tokens and their output bytes; a CTA scan
//      gives each thread its first token's index and output start; a
//      second walk writes the token table (output start, literal length,
//      literal source, offset) and each token's first failing check, and a
//      CTA min finds the segment's first failing token.
//   2. start_kernel, 16 output bytes a thread: each byte's owner token (a
//      binary search for the thread's first byte, then a step forward); a
//      literal byte is resolved to its payload byte, a match byte at
//      offset j into a match of offset off starting at mstart points at
//      mstart - off + j mod off (the mod-hop: before its own match, in an
//      earlier token or in this one's literals). A failed segment's bytes
//      are resolved to 0.
//   3. hop_kernel, `rounds` launches, 4 bytes a thread (16-byte accesses):
//      each unresolved byte follows its pointer up to `hops` times in
//      place (four bytes' chains in step); a launch multiplies every
//      chain's reach by hops + 1, so rounds = ceil(log_(hops + 1)(s / 4))
//      cover the longest chain (a hop goes to an earlier token's match:
//      ops/lz_kernels.py decode_geometry). A launch whose predecessor left
//      nothing returns at once.
//   4. out_kernel: the resolved bytes, 16 a thread, 16-byte stores.
// Error codes (ops/lz_kernels.py ERRORS) are the plain version's: the
// first failing check of the first failing token, in its order (READ on
// the literal 255-run and the literals, WRITE of the literals, READ of the
// offset, OFFSET_ZERO, READ of the match's 255-run, OFFSET_BEFORE, WRITE
// of the match); BAD_LENGTH where no token fails and the lengths differ.
// A segment with a code is all zero in the output.
// Bound: bytes (the payload read once, the output written once, 16 bytes
// of bounds a segment). What holds it back (kennedy.xls, PERF.md): the
// token kernel, one CTA a segment, so 8 of 132 SMs: thread 0's hop chain
// (~110 cycles a hop, ~320 hops), each thread's two parses of its tokens
// and its backward scan; then the pointer rounds' dependent gathers and
// the owner search's dependent loads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lz_common.cuh"

namespace {

constexpr int MIN_MATCH = 4;
constexpr int MAX_THREADS = 512;    // a segment's CTA: a thread a block of positions
constexpr int MIN_LB = 4;           // blocks of at least 16 positions
constexpr int PROBE = 32;           // tokens thread 0 walks before the exits are scanned
constexpr int SMEM_MAX = 220 * 1024;
constexpr uint32_t RESOLVED = 0x80000000u;
constexpr int THREADS = 256;        // the byte passes
enum { OK = 0, OFFSET_ZERO = 1, OFFSET_BEFORE = 2, READ_OVERRUN = 3, WRITE_OVERRUN = 4,
       BAD_LENGTH = 5 };
// where a token's parse stops short: a check that needs no output position
enum { GOES_ON = 0, LIT_EXT, LIT_DATA, OFF_BYTES, OFF_ZERO, MATCH_EXT };

struct Tok {
  int lit, mlen;     // mlen 0: no match (the last token, or stopped); past
                     // 2^31 - 1 it saturates, which fails the length check
  int lsrc, off, nx;  // literal start, offset, next token start (size + 1: none)
  int stop;
};

// The first position at or after q whose byte is not 255, or end: bytes up
// to a 16-byte boundary, then 16 bytes a load.
__device__ int not255(const uint8_t* b, int q, int end) {
  for (; q < end && ((uintptr_t)(b + q) & 15); ++q)
    if (b[q] != 255) return q;
  for (; q + 16 <= end; q += 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(b + q);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (w[k] != 0xffffffffu) return q + 4 * k + ((__ffs(~w[k]) - 1) >> 3);
  }
  for (; q < end; ++q)
    if (b[q] != 255) return q;
  return end;
}

// The token at p of the block b[0..size).
__device__ Tok parse(const uint8_t* b, int p, int size) {
  Tok t{0, 0, 0, 0, size + 1, GOES_ON};
  const int tok = b[p];
  int q = p + 1;
  long long lit = tok >> 4;
  if (lit == 15) {
    const int e = not255(b, q, size);
    if (e >= size) {
      t.stop = LIT_EXT;
      return t;
    }
    lit += 255LL * (e - q) + b[e];
    q = e + 1;
  }
  t.lsrc = q;
  if (q + lit > size) {
    t.stop = LIT_DATA;
    return t;
  }
  t.lit = (int)lit;
  const int r = q + t.lit;
  if (r == size) {   // the last token: literals only
    t.nx = size;
    return t;
  }
  if (r + 2 > size) {
    t.stop = OFF_BYTES;
    return t;
  }
  t.off = b[r] | b[r + 1] << 8;
  if (t.off == 0) {
    t.stop = OFF_ZERO;
    return t;
  }
  int m = r + 2;
  t.mlen = (tok & 15) + MIN_MATCH;
  if ((tok & 15) == 15) {
    const int e = not255(b, m, size);
    if (e >= size) {
      t.mlen = 0;
      t.stop = MATCH_EXT;
      return t;
    }
    t.mlen = (int)min(19 + 255LL * (e - m) + b[e], 0x7fffffffLL);
    m = e + 1;
  }
  t.nx = m;
  return t;
}

// The token's first failing check, its output starting at d of len bytes.
__device__ int token_code(const Tok& t, long long d, long long len) {
  if (t.stop == LIT_EXT || t.stop == LIT_DATA) return READ_OVERRUN;
  if (d + t.lit > len) return WRITE_OVERRUN;
  if (t.stop == OFF_BYTES || t.stop == MATCH_EXT) return READ_OVERRUN;
  if (t.stop == OFF_ZERO) return OFFSET_ZERO;
  if (t.mlen == 0) return OK;
  if (d + t.lit < t.off) return OFFSET_BEFORE;
  if (d + t.lit + (long long)t.mlen > len) return WRITE_OVERRUN;
  return OK;
}

// Exit of position q (in a block ending at hi). SMEM: a byte in shared
// memory, exit - hi, where that is below 255, else (and always without
// SMEM) the int32 in global scratch.
template <bool SMEM>
struct Exits {
  uint8_t* e8;
  int* g;

  __device__ __forceinline__ int get(int q, int hi) const {
    if (SMEM && e8[q] != 255) return hi + e8[q];
    return g[q];
  }
  __device__ __forceinline__ void put(int q, int hi, int e) {
    if (SMEM) {
      e8[q] = (uint8_t)min(e - hi, 255);
      if (e - hi < 255) return;
    }
    g[q] = e;
  }
};

// The shared state of a segment's CTA.
struct Shared {
  int entry[MAX_THREADS];   // where the walk enters each block (-1: it does not)
  int wc[32];               // the scan's warp totals: tokens, output bytes
  long long wo[32];
  unsigned long long first;  // the first failing token: index << 8 | code
  int probe_end;
};

// next(p) for every position of every segment's block, a thread a
// position (chunks CTAs a segment, striding over its block).
__global__ void __launch_bounds__(THREADS)
next_kernel(const uint8_t* __restrict__ comp, const long long* __restrict__ bases,
            const long long* __restrict__ sizes, int* __restrict__ nxt, int chunks) {
  const int seg = blockIdx.x / chunks, c = blockIdx.x % chunks;
  const long long base = bases[seg];
  const int size = (int)sizes[seg];
  for (int p = c * THREADS + threadIdx.x; p < size; p += chunks * THREADS)
    nxt[base + p] = parse(comp + base, p, size).nx;
}

// A segment's tokens from its block and the next table nx: the probe, the
// exits and hops where the probe does not reach the end, the re-walks, the
// token table and the code (design note, step 1). SMEM: the exits are
// bytes in shared memory, the block staged at b (else b is the block,
// staged or in place, and the exits int32 in global scratch). NXS: next()
// is staged in shared memory at b until the hops are done, and the block
// after them.
template <bool SMEM, bool NXS>
__device__ __forceinline__ void segment_tokens(const uint8_t* comp, uint8_t* b, Exits<SMEM> ex,
                                               const int* __restrict__ nx, int size,
                                               long long len, int tcap, int4* row, Shared& sh,
                                               int& code, int& tokens) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (NXS) {
    ct::stage(b, reinterpret_cast<const uint8_t*>(nx), 4 * size);
    nx = reinterpret_cast<const int*>(b);
    __syncthreads();
  }
  // blocks of 2^lb + 4 positions: a lane's block starts a bank after the
  // lane before's, so the lanes' loads in step hit 32 banks, not one
  int lb = MIN_LB;
  while ((long long)nt * ((1 << lb) + 4) < size || (1LL << (2 * lb)) < size / 3) ++lb;
  const int blen = (1 << lb) + 4;
  const int nb = (size + blen - 1) / blen;
  if (tid == 0) {   // a block of few tokens (incompressible, or one run) needs no exits
    int p = 0;
    for (int k = 0; p < size && k < PROBE; ++k) {
      if (sh.entry[p / blen] < 0) sh.entry[p / blen] = p;
      p = nx[p];
    }
    sh.probe_end = p;
  }
  __syncthreads();
  const int lo = tid * blen;
  const int hi = tid < nb ? min(lo + blen, size) : 0;
  if (sh.probe_end < size) {
    for (int p = hi - 1; p >= lo; p -= 8) {   // 8 loads of next() in flight
      int q[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) q[j] = p - j >= lo ? nx[p - j] : 0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (p - j >= lo) ex.put(p - j, hi, q[j] >= hi ? q[j] : ex.get(q[j], hi));
    }
    __syncthreads();
    if (tid == 0) {
      // the walk leaves a block at each hop: only the probe's last block
      // may hold an entry already. An exit hi + v with v < 255 lies v /
      // blen blocks past the next one; no division on the chain but where
      // an exit is 255 or more past its block.
      int p = sh.probe_end, k = p / blen;
      if (p < size && sh.entry[k] < 0) sh.entry[k] = p;
      while (p < size) {
        const int hi_k = min((k + 1) * blen, size);
        const int v = SMEM ? ex.e8[p] : 255;
        if (v != 255) {
          p = hi_k + v;
          k += 1 + (v >= blen ? v / blen : 0);
        } else {
          p = ex.g[p];
          k = p / blen;
        }
        if (p < size) sh.entry[k] = p;
      }
    }
    __syncthreads();
  }
  if (NXS) {
    ct::stage(b, comp, size);
    __syncthreads();
  }
  const int e0 = tid < nb ? sh.entry[tid] : -1;
  int c = 0;
  long long o = 0;
  for (int p = e0; p >= 0 && p < hi;) {
    const Tok t = parse(b, p, size);
    ++c;
    o += (long long)t.lit + t.mlen;
    p = t.nx;
  }
  // exclusive scan of (tokens, output bytes) over the CTA
  const int lane = tid & 31, wid = tid >> 5, nw = nt >> 5;
  int vc = c;
  long long vo = o;
  for (int k = 1; k < 32; k <<= 1) {
    const int uc = __shfl_up_sync(0xffffffffu, vc, k);
    const long long uo = __shfl_up_sync(0xffffffffu, vo, k);
    if (lane >= k) {
      vc += uc;
      vo += uo;
    }
  }
  if (lane == 31) {
    sh.wc[wid] = vc;
    sh.wo[wid] = vo;
  }
  __syncthreads();
  if (wid == 0) {
    int xc = lane < nw ? sh.wc[lane] : 0;
    long long xo = lane < nw ? sh.wo[lane] : 0;
    for (int k = 1; k < 32; k <<= 1) {
      const int uc = __shfl_up_sync(0xffffffffu, xc, k);
      const long long uo = __shfl_up_sync(0xffffffffu, xo, k);
      if (lane >= k) {
        xc += uc;
        xo += uo;
      }
    }
    sh.wc[lane] = xc;
    sh.wo[lane] = xo;
  }
  __syncthreads();
  int k = vc - c + (wid > 0 ? sh.wc[wid - 1] : 0);
  long long d = vo - o + (wid > 0 ? sh.wo[wid - 1] : 0);
  for (int p = e0; p >= 0 && p < hi;) {
    const Tok t = parse(b, p, size);
    const int cd = token_code(t, d, len);
    if (cd != OK) {
      atomicMin(&sh.first, (unsigned long long)k << 8 | cd);
      break;
    }
    if (k < tcap) row[k] = make_int4((int)d, t.lit, t.lsrc, t.off);
    ++k;
    d += (long long)t.lit + t.mlen;
    p = t.nx;
  }
  __syncthreads();
  tokens = sh.wc[nw - 1];
  code = sh.first != ~0ull ? (int)(sh.first & 255) : sh.wo[nw - 1] == len ? OK : BAD_LENGTH;
}

__global__ void __launch_bounds__(MAX_THREADS, 1)
token_kernel(const uint8_t* __restrict__ comp, const long long* __restrict__ bases,
             const long long* __restrict__ sizes, const int* __restrict__ nxt, int* gex,
             int4* __restrict__ rec, int* __restrict__ ntok, int32_t* __restrict__ err,
             int* __restrict__ pending, int n_pending, long long n, long long s, int tcap,
             int smem_bytes) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Shared sh;
  const int seg = blockIdx.x, tid = threadIdx.x;
  if (seg == 0)
    for (int i = tid; i < n_pending; i += blockDim.x) pending[i] = 0;
  const long long base = bases[seg];
  const int size = (int)sizes[seg];
  const long long len = min(s, n - seg * s);
  sh.entry[tid] = -1;
  if (tid == 0) sh.first = ~0ull;
  int4* row = rec + (long long)seg * tcap;
  int code, tokens;
  // the block in shared memory, with a byte of exit a position beside it
  // where both fit; else int32 exits in global scratch, and the block read
  // in place where it does not fit either
  const int size16 = (size + 15) & ~15;
  const Exits<true> e8{smem, gex + base};
  if (5LL * size16 <= smem_bytes) {   // next() too, until the hops are done
    __syncthreads();
    segment_tokens<true, true>(comp + base, smem + size16, e8, nxt + base, size, len, tcap, row,
                               sh, code, tokens);
  } else if (2LL * size16 <= smem_bytes) {
    ct::stage(smem + size16, comp + base, size);
    __syncthreads();
    segment_tokens<true, false>(comp + base, smem + size16, e8, nxt + base, size, len, tcap,
                                row, sh, code, tokens);
  } else {
    const bool staged = size <= smem_bytes;
    if (staged) ct::stage(smem, comp + base, size);
    __syncthreads();
    segment_tokens<false, false>(comp + base, staged ? smem : const_cast<uint8_t*>(comp + base),
                                 Exits<false>{nullptr, gex + base}, nxt + base, size, len, tcap,
                                 row, sh, code, tokens);
  }
  if (tid == 0) {
    err[seg] = code;
    ntok[seg] = min(tokens, tcap);
  }
}

__device__ __forceinline__ long long seg_of(long long g, long long s, int lg) {
  return lg >= 0 ? g >> lg : g / s;
}

__global__ void __launch_bounds__(THREADS)
start_kernel(const uint8_t* __restrict__ comp, const long long* __restrict__ bases,
             const int4* __restrict__ rec, const int* __restrict__ ntok,
             const int32_t* __restrict__ err, uint32_t* __restrict__ src, int* pending,
             long long n, long long s, int lg, int tcap) {
  const long long g0 = ((long long)blockIdx.x * THREADS + threadIdx.x) * 16;
  if (g0 >= n) return;
  uint32_t v[16];
  int lit[16];   // a literal byte's payload index (its load after the loop), or -1
  long long segend = 0, d = 0, base = 0;
  const int4* r = nullptr;
  int4 cur = make_int4(0, 0, 0, 1);
  int t = 0, nt = 0, code = 0;
  bool left = false;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const long long g = g0 + k;
    v[k] = RESOLVED;
    lit[k] = -1;
    if (g >= n) continue;
    if (g >= segend) {   // the thread's first byte, or a segment's first
      const long long seg = seg_of(g, s, lg);
      segend = min(seg * s + s, n);
      d = g - seg * s;
      code = err[seg];
      if (code != OK) continue;
      base = bases[seg];
      nt = ntok[seg];
      r = rec + seg * tcap;
      int a = 0, z = nt - 1;   // the last token whose output starts at or before d
      while (a < z) {
        const int mid = (a + z + 1) >> 1;
        if (r[mid].x <= d) a = mid;
        else z = mid - 1;
      }
      t = a;
      cur = r[t];
    } else {
      ++d;
    }
    if (code != OK) continue;
    while (t + 1 < nt && r[t + 1].x <= d) cur = r[++t];
    const long long j = d - cur.x;
    if (j < cur.y) {
      lit[k] = (int)(base + cur.z + j);
    } else {
      const long long mj = j - cur.y;
      v[k] = (uint32_t)(cur.x + cur.y - cur.w + (int)(mj % cur.w));
      left = true;
    }
  }
#pragma unroll
  for (int k = 0; k < 16; ++k)   // the literals' loads, all in flight
    if (lit[k] >= 0) v[k] = RESOLVED | comp[lit[k]];
  uint4* dst = reinterpret_cast<uint4*>(src + g0);
#pragma unroll
  for (int q = 0; q < 4; ++q) dst[q] = make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  if (left) pending[0] = 1;
}

__global__ void __launch_bounds__(THREADS)
hop_kernel(uint32_t* src, int* pending, int round, int hops, long long n, long long s, int lg) {
  if (pending[round] == 0) return;
  const long long g0 = ((long long)blockIdx.x * THREADS + threadIdx.x) * 4;
  if (g0 >= n) return;
  uint4 q = *reinterpret_cast<const uint4*>(src + g0);
  uint32_t v[4] = {q.x, q.y, q.z, q.w};
  const uint32_t* row[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) row[k] = src + seg_of(g0 + k, s, lg) * s;
  // the four bytes' chains in step: their loads in flight together
  bool left = false;
  for (int h = 0; h < hops; ++h) {
    left = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!(v[k] & RESOLVED)) v[k] = row[k][v[k]];
      left |= !(v[k] & RESOLVED);
    }
    if (!left) break;
  }
  *reinterpret_cast<uint4*>(src + g0) = make_uint4(v[0], v[1], v[2], v[3]);
  if (left) pending[round + 1] = 1;
}

__global__ void __launch_bounds__(THREADS)
out_kernel(const uint32_t* __restrict__ src, uint8_t* __restrict__ out, long long n) {
  const long long g0 = ((long long)blockIdx.x * THREADS + threadIdx.x) * 16;
  if (g0 >= n) return;
  const uint4* s4 = reinterpret_cast<const uint4*>(src + g0);
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 a = s4[q];
    w[q] = (a.x & 255) | (a.y & 255) << 8 | (a.z & 255) << 16 | (a.w & 255) << 24;
  }
  if (g0 + 16 <= n) {
    *reinterpret_cast<uint4*>(out + g0) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    for (int k = 0; g0 + k < n; ++k) out[g0 + k] = (uint8_t)(w[k >> 2] >> (8 * (k & 3)));
  }
}

int blocks_of(long long items, int per) {
  return (int)((items + (long long)per * THREADS - 1) / ((long long)per * THREADS));
}

}  // namespace

// comp uint8 [total], bases and sizes int64 [n_segs] -> out uint8 [n]
// (segment i at i * s; zero where it failed), err int32 [n_segs]. Scratch,
// uninitialised: nxt and exits int32 [total], rec int32 [n_segs * tcap, 4], ntok
// int32 [n_segs], src int32 [n rounded up to 16], pending int32
// [rounds + 1]. s is min(s, n); tcap = s / 4 + 2 tokens a segment (no
// segment that decodes has more); rounds and hops as ops/lz_kernels.py
// decode_geometry gives them.
extern "C" int ct_lz_decode(const void* comp, const void* bases, const void* sizes, void* nxt,
                            void* exits, void* rec, void* ntok, void* src, void* pending,
                            void* out, void* err, int n_segs, long long n, long long s, int tcap,
                            int rounds, int hops, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  // a valid block of s bytes has at most s + s/255 + 2: its exits beside it
  const long long cap = s + s / 255 + 16;
  const int smem = (int)min((long long)SMEM_MAX, 5 * ((cap + 15) & ~15LL));
  const int threads = (int)min((long long)MAX_THREADS, ((cap + 16 * 32 - 1) / (16 * 32)) * 32);
  cudaError_t e = cudaFuncSetAttribute(token_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem);
  if (e != cudaSuccess) return (int)e;
  int lg = -1;
  if (n_segs > 1 && (s & (s - 1)) == 0)
    while ((1LL << (lg + 1)) <= s) ++lg;
  const int chunks = (int)min(128LL, (cap + THREADS - 1) / THREADS);
  next_kernel<<<(unsigned)((long long)n_segs * chunks), THREADS, 0, st>>>(
      (const uint8_t*)comp, (const long long*)bases, (const long long*)sizes, (int*)nxt, chunks);
  token_kernel<<<n_segs, threads, smem, st>>>(
      (const uint8_t*)comp, (const long long*)bases, (const long long*)sizes,
      (const int*)nxt, (int*)exits,
      (int4*)rec, (int*)ntok, (int32_t*)err, (int*)pending, rounds + 1, n, s, tcap, smem);
  start_kernel<<<blocks_of(n, 16), THREADS, 0, st>>>(
      (const uint8_t*)comp, (const long long*)bases, (const int4*)rec, (const int*)ntok,
      (const int32_t*)err, (uint32_t*)src, (int*)pending, n, s, lg, tcap);
  for (int r = 0; r < rounds; ++r)
    hop_kernel<<<blocks_of(n, 4), THREADS, 0, st>>>((uint32_t*)src, (int*)pending, r, hops, n, s,
                                                     lg);
  out_kernel<<<blocks_of(n, 16), THREADS, 0, st>>>((const uint32_t*)src, (uint8_t*)out, n);
  return (int)cudaGetLastError();
}
