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
// P. Segment i's walk goes from position 0 to p + step(p) until it passes
// the last position where a match may start (limit = L - LAST_MATCH_GUARD
// + 1); step(p) is the match's length where p takes one (valid, and not
// deferred by the lazy rule), else 1. A first design took step and off
// arrays built by about 15 tensor ops, ran one CTA a segment whose threads
// scanned 128-position blocks backwards with every exit an int32 in global
// memory (an L2 round trip a step), then one thread hopped up to 1,024
// blocks along those exits (a dependent global load and a division a hop),
// and two re-walks read step from global memory: 0.367 ms at kennedy.xls
// on an H100 (PERF.md). Now two launches:
//   1. step_kernel, over the whole card (a CTA a tile of 4,096 positions of
//      a segment; a segment's CTA alone would read its 16 bytes a position
//      of lcp and cand at one SM's rate): the walk's inputs from the match
//      table, coalesced (the length capped END_LITERALS before the end,
//      the validity rule, the lazy rule from position p + 1), then each
//      position's exit, the first position of the walk from p at or past
//      the end of p's block (blocks of 2^lb positions), by pointer jumping
//      in shared memory (exit <- exit[exit] while inside the block: about
//      lb rounds, not a chain of 2^lb dependent steps). Written to a
//      scratch row a segment: step - 1 as a byte (255: a match of 256 or
//      more, whose length is read again from lcp) and the exit as 12 bits,
//      exit - block end, a byte and a nibble (a step is at most LCP_CAP =
//      4,096, so an exit lies less than 4,096 past its block's end: no
//      escape to global memory, no branch on the hop chain);
//   2. walk_kernel, a CTA a segment. Up to W = 2^17 it runs 1,024 threads,
//      a thread a block, and stages the exits in shared memory (1.5 bytes
//      a position: 192 KB at 2^17, 8 loads in flight a thread). The hops:
//      one a block the walk enters, p = (p | 2^lb - 1) + 1 + exit(p), two
//      independent shared loads and no division. A single chain would be
//      W / 2^lb hops long (~80 cycles each on an H100), so lane 0 of up to 8
//      warps each hops a region of the blocks from its first position,
//      as if the walk entered there; thread 0 then carries the walk itself
//      into each region until it lands on a position of the region's chain
//      (greedy parses from nearby starts meet within a few tokens), whose
//      entries from there on are the walk's. Chains of long matches at
//      other phases (runs, exact repeats) may never meet: thread 0 then
//      hops the region itself, no slower than one chain. Then the step
//      bytes take the exits' place, blocks 2^lb + 4 bytes apart (so
//      the lanes, walking their blocks in step, read 32 banks, not one),
//      and each thread walks its block once from its entry, a word of step
//      bytes a turn (a word of literals is skipped whole; a match's byte
//      comes from the same word, so lanes meeting literals and matches
//      move on together), and stages its matches' offsets (u16, at most
//      2^lb / 4 + 1 a block) beside them. A CTA scan gives each block its
//      first slot; each warp then writes 32 consecutive matches at a time
//      (coalesced; a lane finds its match's block by a binary search of the
//      prefixes, and loads cand for the offset), and the CTA zeroes the
//      rows past the count. Above 2^17 (one segment at seg_log2 >= 18, up
//      to 2^30) the exits, entries and steps are read in global memory
//      (one hop chain), each thread walking ceil(blocks / 1,024) blocks
//      twice (count, then write).
// lb (ops/lz_kernels.py walk_geometry) is the least >= 4 with 4^lb >= W / 8
// where staged (2^7 at 2^17: 1,024 blocks; 2^6 at a 2^14 CT-SB superblock),
// else the least with 4^lb >= 2W (each hop a global load), at most 12.
// Bound: bytes (lcp and cand where the walk goes and after each match,
// lens, the outputs whole). What holds it back (H100): each block's walk
// (~60-90 cycles a word of step bytes, a long match's length read again from
// global memory) and the writes (a binary search and a load of cand a
// match), in one CTA a segment (8 of 132 SMs at kennedy.xls); launch 1's
// rounds of barriers.
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

constexpr int MIN_MATCH = 4;
constexpr int END_LITERALS = 5;
constexpr int LAST_MATCH_GUARD = 12;
constexpr int STEP_TILE = 4096;          // P, launch 1: positions a CTA
constexpr int STEP_THREADS = 512;
constexpr int STEP_PER = STEP_TILE / STEP_THREADS;
constexpr int WALK_THREADS = 1024;       // P, launch 2: the most threads a segment's CTA
constexpr int WALK_STAGED_W = 1 << 17;   // the widest segment whose exits are staged
constexpr int WALK_SMEM_MAX = 212 * 1024;  // dynamic, beside ~8.3 KB static: within 227 KB
constexpr int HOP_REGIONS = 8;           // launch 2's hop chains, a warp each
constexpr int HOP_MIN_BLOCKS = 16;       // blocks a region at least
constexpr unsigned FULL = 0xffffffffu;
constexpr int Q_MAX_THREADS = 1024;     // Q's first launch: a CTA a segment
constexpr int Q_SMEM_MAX = 220 * 1024;  // the most dynamic shared memory launch 1 takes
constexpr int PLACE_THREADS = 256;      // Q's second launch
constexpr int PLACE_BYTES = 16;         // payload bytes a thread
constexpr int CHUNK = PLACE_THREADS * PLACE_BYTES;

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

// P, launch 1: a CTA a tile of STEP_TILE positions of a segment (a
// grid-stride loop over segments x tiles; a tile holds whole blocks). Each
// thread takes STEP_PER positions, STEP_THREADS apart (the loads of lcp and
// cand coalesced; p + 1, for the lazy rule, is the next lane's). Tiles
// past the last position where a match may start are never read.
__global__ void __launch_bounds__(STEP_THREADS)
step_kernel(const long long* __restrict__ lcp, const long long* __restrict__ cand,
            const long long* __restrict__ lens, uint8_t* __restrict__ planes, int w, int lb,
            int lazy, int tiles, long long tasks, long long pstride) {
  __shared__ int ex[STEP_TILE];
  const int w16 = (w + 15) & ~15, h16 = ((w + 1) / 2 + 15) & ~15;
  const int tid = threadIdx.x;
  for (long long t = blockIdx.x; t < tasks; t += gridDim.x) {
    const long long seg = t / tiles;
    const int a = (int)(t - seg * tiles) * STEP_TILE;
    const long long len = lens[seg];
    const int limit = (int)max(0LL, min((long long)w, len - LAST_MATCH_GUARD + 1));
    if (a >= limit) continue;
    const int m = min(STEP_TILE, w - a);
    const long long* lc = lcp + seg * w;
    const long long* cd = cand + seg * w;
    uint8_t* row = planes + seg * pstride;
    uint8_t* sb = row + (w16 + h16);
    int e[STEP_PER], hi[STEP_PER];   // tile-relative: the exit so far, the block's end
    int busy = 0;
#pragma unroll
    for (int k = 0; k < STEP_PER; ++k) {
      const int i = tid + k * STEP_THREADS;
      e[k] = hi[k] = 0;
      if (i < m) {
        const int p = a + i;
        const long long m0 = min(lc[p], len - END_LITERALS - p);
        bool v = cd[p] >= 0 && p <= len - LAST_MATCH_GUARD && m0 >= MIN_MATCH;
        if (lazy && p + 1 < w) {   // deferred where p + 1 holds a longer valid match
          const long long m1 = min(lc[p + 1], len - END_LITERALS - p - 1);
          v = v && !(cd[p + 1] >= 0 && p + 1 <= len - LAST_MATCH_GUARD && m1 >= MIN_MATCH &&
                     m1 > m0);
        }
        const int s = v ? (int)m0 : 1;
        sb[p] = (uint8_t)min(s - 1, 255);
        hi[k] = min(((i >> lb) + 1) << lb, m);
        e[k] = i + s;
        ex[i] = e[k];
        busy |= e[k] < hi[k];
      }
    }
    // exit <- exit[exit] while inside the block: each round at least
    // doubles the walk steps an exit covers. In place: a value read while
    // another thread rewrites it is a position of the same walk either way.
    while (__syncthreads_or(busy)) {
      busy = 0;
#pragma unroll
      for (int k = 0; k < STEP_PER; ++k) {
        if (e[k] < hi[k]) {
          e[k] = ex[e[k]];
          ex[tid + k * STEP_THREADS] = e[k];
          busy |= e[k] < hi[k];
        }
      }
    }
    // exit - block end (< 4,096: a step is at most LCP_CAP): its low byte,
    // and its high nibble packed two positions a byte (position 2j in the
    // low half); the pair's odd position is the next lane's
#pragma unroll
    for (int k = 0; k < STEP_PER; ++k) {
      const int i = tid + k * STEP_THREADS;
      const int v = e[k] - hi[k];
      const int up = __shfl_down_sync(FULL, v >> 8, 1);
      if (i < m) {
        row[a + i] = (uint8_t)v;
        if (!(i & 1)) row[w16 + ((a + i) >> 1)] = (uint8_t)((v >> 8) | (i + 1 < m ? up << 4 : 0));
      }
    }
    __syncthreads();   // ex is the next tile's
  }
}

// A match's length from its step byte (255: 256 or more, read from lcp).
__device__ __forceinline__ int match_len(int code, const long long* lc, long long len, int q) {
  return code != 255 ? code + 1 : (int)min(lc[q], len - END_LITERALS - q);
}

// The walk from p < end over the step bytes sb (4-byte aligned, its words
// readable up to end rounded up to 4; bytes at or past end do not count):
// f(q, length) at each match q < end. One loop, a word a turn: a word of
// literals moves p to the next word, else the match's step byte comes from
// the same word (no second load), so a warp's lanes move on together
// whether they meet literals or matches.
template <class F>
__device__ __forceinline__ void walk_matches(const uint8_t* sb, int p, int end, const long long* lc,
                                            long long len, int pos0, F f) {
  while (p < end) {
    const uint32_t x = *reinterpret_cast<const uint32_t*>(sb + (p & ~3)) >> (8 * (p & 3));
    if (x == 0) {
      p = (p | 3) + 1;
      continue;
    }
    const int k = (__ffs(x) - 1) >> 3, q = p + k;
    if (q >= end) return;
    const int s = match_len((x >> (8 * k)) & 255, lc, len, pos0 + q);
    f(q, s);
    p = q + s;
  }
}

// r[from, to) = 0 by the CTA, 16-byte stores where aligned.
__device__ void zero_tail(int32_t* r, int from, int to) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int i0 = min(to, from + (int)((16 - ((uintptr_t)(r + from) & 15)) & 15) / 4);
  const int i1 = i0 + (to - i0) / 4 * 4;
  for (int i = from + tid; i < i0; i += nt) r[i] = 0;
  for (int i = i0 + 4 * tid; i < i1; i += 4 * nt) *reinterpret_cast<int4*>(r + i) = make_int4(0, 0, 0, 0);
  for (int i = i1 + tid; i < to; i += nt) r[i] = 0;
}

// The CTA copies n16 16-byte chunks of src (global) into shared memory,
// eight loads in flight a thread: chunk i to dst + 16 i, or with PAD (the
// step bytes) to dst + 16 i + 4 (16 i >> lb), 4 bytes after each block of
// 2^lb, so the lanes walking their blocks in step read 32 banks, not one.
template <bool PAD>
__device__ __forceinline__ void stage_rows(uint8_t* dst, const uint8_t* src, int n16, int lb) {
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  const int nt = blockDim.x;
  for (int i0 = threadIdx.x; i0 < n16; i0 += 8 * nt) {
    uint4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (i0 + u * nt < n16) v[u] = s4[i0 + u * nt];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * nt;
      if (i >= n16) continue;
      if (PAD) {
        uint32_t* d = reinterpret_cast<uint32_t*>(dst + 16 * i + ((16 * i) >> lb) * 4);
        d[0] = v[u].x;
        d[1] = v[u].y;
        d[2] = v[u].z;
        d[3] = v[u].w;
      } else {
        reinterpret_cast<uint4*>(dst)[i] = v[u];
      }
    }
  }
}

// P, launch 2: a CTA a segment. STAGED (W <= WALK_STAGED_W): 1,024
// threads, a thread a block (the others stage, write and zero); in shared
// memory the exits, then the step bytes (blocks 2^lb + 4 apart) and each
// block's matches (u16 offsets, 2^lb / 4 + 1 slots a block), the entries,
// then the scan's prefixes. Else the exits, entries (gentry) and steps in
// global memory, bpt blocks a thread, walked twice: to count, then to
// write.
template <bool STAGED>
__global__ void __launch_bounds__(WALK_THREADS)
walk_kernel(const long long* __restrict__ lcp, const long long* __restrict__ cand,
            const long long* __restrict__ lens, const uint8_t* __restrict__ planes,
            int* gentry, int32_t* __restrict__ mpos, int32_t* __restrict__ mlen,
            int32_t* __restrict__ moff, int32_t* __restrict__ count, int w, int lb, int nb,
            int bpt, int tcap, long long pstride) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int sentry[STAGED ? WALK_THREADS : 1];
  __shared__ int warp_sum[32];
  const int seg = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int w16 = (w + 15) & ~15, h16 = ((w + 1) / 2 + 15) & ~15;
  const int bstride = (1 << lb) + 4, capb = (1 << lb) / 4 + 1;
  const long long len = lens[seg];
  const int limit = (int)max(0LL, min((long long)w, len - LAST_MATCH_GUARD + 1));
  const uint8_t* row = planes + seg * pstride;
  const long long* lc = lcp + (long long)seg * w;
  const long long* cd = cand + (long long)seg * w;
  int* entry = STAGED ? sentry : gentry + (long long)seg * nb;
  if (STAGED) stage_rows<false>(smem, row, (w16 + h16) / 16, lb);
  // the hops. Staged, lane 0 of warp r hops region r (blocks [r * per, (r
  // + 1) * per), up to HOP_REGIONS) from its first position, as if the
  // walk entered there, into spec (region 0: the walk itself, into entry).
  // One hop a block entered: the exit, 12 bits past the block's end
  // (2^lb-aligned), two independent loads and no division.
  const uint8_t* elo = STAGED ? smem : row;
  const uint8_t* ehi = elo + w16;
  const int mask = (1 << lb) - 1;
  auto hop = [&](int p) {
    return (p | mask) + 1 + (elo[p] | (ehi[p >> 1] >> ((p & 1) << 2) & 15) << 8);
  };
  __shared__ int spec[STAGED ? WALK_THREADS : 1];
  __shared__ int reg_end[HOP_REGIONS], met[HOP_REGIONS];
  const int regions = STAGED ? max(1, min(HOP_REGIONS, nb / HOP_MIN_BLOCKS)) : 1;
  const int per = (nb + regions - 1) / regions;
  for (int b = tid; b < nb; b += nt) {
    entry[b] = -1;
    if (STAGED) spec[b] = -1;
  }
  __syncthreads();
  if ((tid & 31) == 0 && (tid >> 5) < regions) {
    const int r = tid >> 5;
    int* e = r == 0 ? entry : spec;
    const int hi = (int)min((long long)min(r * per + per, nb) << lb, (long long)limit);
    int p = (r * per) << lb;
    for (; p < hi; p = hop(p)) e[p >> lb] = p;
    reg_end[r] = p;
  }
  __syncthreads();
  if (tid == 0) {
    // the walk itself enters region r at p: it hops on until it lands on a
    // position of the region's chain (greedy parses from nearby starts
    // meet within a few tokens; chains of long matches at other phases may
    // not), whose entries from block met[r] on are its own. The check's
    // load goes beside the hop's, off the chain.
    int p = reg_end[0];
    for (int r = 1; r < regions; ++r) {
      const int b1 = min(r * per + per, nb);
      const int hi = (int)min((long long)b1 << lb, (long long)limit);
      met[r] = b1;
      while (p < hi) {
        const int k = p >> lb, at = spec[k], q = hop(p);
        if (at == p) {
          met[r] = k;
          p = reg_end[r];
          break;
        }
        entry[k] = p;
        p = q;
      }
    }
  }
  __syncthreads();
  if (STAGED) {   // the step bytes in the exits' place, each block padded
    stage_rows<true>(smem, row + (w16 + h16), w16 / 16, lb);
    __syncthreads();
  }
  const int b0 = tid * bpt, b1 = min(b0 + bpt, nb);
  const int lo = b0 << lb, end = (int)min((long long)b1 << lb, (long long)limit);
  // the thread's blocks' step bytes, indexed from lo
  const uint8_t* sb = STAGED ? smem + b0 * bstride : row + (w16 + h16) + lo;
  uint16_t* stg = reinterpret_cast<uint16_t*>(smem + ((nb * bstride + 15) & ~15));
  int start = -1;   // the walk's first position in the thread's blocks
  if (STAGED && b0 < nb) {
    const int r = b0 / per;
    start = r > 0 && b0 >= met[r] ? spec[b0] : entry[b0];
  } else {
    for (int b = b0; b < b1 && start < 0; ++b) start = entry[b];
  }
  int c = 0;
  if (start >= 0)
    walk_matches(sb, start - lo, end - lo, lc, len, lo, [&](int q, int) {
      if (STAGED) stg[tid * capb + c] = (uint16_t)q;
      ++c;
    });
  const int2 sc = cta_scan(c, warp_sum);
  const long long orow = (long long)seg * tcap;
  int32_t *op = mpos + orow, *ol = mlen + orow, *oo = moff + orow;
  if (STAGED) {
    // 32 consecutive matches a warp at a time, two chunks a turn
    // (coalesced stores; more chunks a turn, with their searches in step,
    // were slower): each lane finds its match's block by a binary search
    // of the prefixes
    int* kk = sentry;
    if (tid < nb) kk[tid] = sc.x;
    __syncthreads();
    const int lane = tid & 31, nw = nt >> 5;
    for (int c0 = (tid >> 5) * 32; c0 < sc.y; c0 += 2 * nw * 32) {
      int q[2];
      long long src[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int m = c0 + u * nw * 32 + lane;
        if (m < sc.y) {
          int a = 0, z = nb - 1;   // the last block whose first slot is at or before m
          while (a < z) {
            const int mid = (a + z + 1) >> 1;
            if (kk[mid] <= m) a = mid;
            else z = mid - 1;
          }
          q[u] = (a << lb) + stg[a * capb + m - kk[a]];
          src[u] = cd[q[u]];
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int m = c0 + u * nw * 32 + lane;
        if (m < sc.y) {
          op[m] = q[u];
          ol[m] = match_len(smem[q[u] + (q[u] >> lb) * 4], lc, len, q[u]);
          oo[m] = q[u] - (int)src[u];
        }
      }
    }
  } else if (start >= 0) {
    int k = sc.x;
    walk_matches(sb, start - lo, end - lo, lc, len, lo, [&](int q, int s) {
      op[k] = lo + q;
      ol[k] = s;
      oo[k] = lo + q - (int)cd[lo + q];
      ++k;
    });
  }
  zero_tail(op, sc.y, tcap);
  zero_tail(ol, sc.y, tcap);
  zero_tail(oo, sc.y, tcap);
  if (tid == 0) count[seg] = sc.y;
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

// lcp, cand int64 [n, w] (the v2 match table: lcp <= LCP_CAP, cand -1 or
// a position before), lens int64 [n], lazy -> mpos, mlen, moff int32 [n,
// tcap] (the walk's matches in order, zero past the count: written whole)
// and count int32 [n]. Scratch: planes uint8 [n, 2 * w16 + h16] (w16 = w
// rounded up to 16, h16 = ceil(w / 2) rounded up to 16) and, above
// WALK_STAGED_W, entries int32 [n, nb]. Blocks of 2^lb positions, lb in 4
// .. 12, as ops/lz_kernels.py walk_geometry picks it.
extern "C" int ct_lz_walk(const void* lcp, const void* cand, const void* lens, void* planes,
                          void* entries, void* mpos, void* mlen, void* moff, void* count, int n,
                          int w, int lb, int lazy, int tcap, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (lb < 4 || lb > 12) return (int)cudaErrorInvalidValue;
  const int nb = ((w - 1) >> lb) + 1;
  const int threads = min(WALK_THREADS, (nb + 31) / 32 * 32);
  const int bpt = (nb + threads - 1) / threads;
  const long long w16 = (w + 15) & ~15LL, h16 = ((w + 1LL) / 2 + 15) & ~15LL;
  const long long pstride = 2 * w16 + h16;
  const int tiles = (w + STEP_TILE - 1) / STEP_TILE;
  const long long tasks = (long long)n * tiles;
  step_kernel<<<(unsigned)min(tasks, 1LL << 20), STEP_THREADS, 0, st>>>(
      (const long long*)lcp, (const long long*)cand, (const long long*)lens, (uint8_t*)planes, w,
      lb, lazy, tiles, tasks, pstride);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (w <= WALK_STAGED_W) {
    // the exits (w16 + h16 bytes), then the padded steps and the staged
    // matches
    const long long smem = max(w16 + h16, ((nb * ((1LL << lb) + 4) + 15) & ~15LL) +
                                              2LL * nb * ((1 << lb) / 4 + 1));
    if (nb > WALK_THREADS || smem > WALK_SMEM_MAX) return (int)cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(walk_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    walk_kernel<true><<<n, WALK_THREADS, (int)smem, st>>>(
        (const long long*)lcp, (const long long*)cand, (const long long*)lens,
        (const uint8_t*)planes, nullptr, (int32_t*)mpos, (int32_t*)mlen, (int32_t*)moff,
        (int32_t*)count, w, lb, nb, 1, tcap, pstride);
  } else {
    walk_kernel<false><<<n, threads, 0, st>>>(
        (const long long*)lcp, (const long long*)cand, (const long long*)lens,
        (const uint8_t*)planes, (int*)entries, (int32_t*)mpos, (int32_t*)mlen, (int32_t*)moff,
        (int32_t*)count, w, lb, nb, bpt, tcap, pstride);
  }
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
