// Kernels M and N: CT-MTF1 move-to-front encode (M) and decode (N), plain
// MTF and the reference's MTF-1, on Hopper.
//
// They replace no Pallas kernel: the JAX package runs MTF as one compiled
// lax.scan over the 2^15 steps of a block, batched over blocks
// (cpprcoder_tpu/ops/mtf_ops.py:45-81; semantics in reference/mtf_ref.py:
// 20-58, the reference's blksort.h:663-793).
//
// What they compute, per 2^15-byte block (independent, initial list the
// identity, prev = 1): encode emits each byte's position r in the list and
// decode the list's entry at the given r; then the entry at r moves to dst:
//   - MTF: dst = 0 (when r > 0);
//   - MTF-1: dst = 1 when r > 1; when r == 1, dst = 0 only if the previous
//     rank was not 0 (a swap of the first two), else no move;
// the entries at dst..r-1 move up by one. The last block is cut at n.
//
// Design: a cluster of CLUSTER CTAs a block, WARPS warps a CTA, each warp
// one of the block's SEGS segments (seg bytes, a multiple of 4; a short
// block gets short segments, so every warp still has work). Each segment
// runs from the exact list it starts with, computed in shared memory
// between barriers (across the cluster through distributed shared memory);
// nothing is guessed and nothing repaired. A move depends only on r and the
// previous rank, never on which byte sits where, which gives both start
// lists:
//   - N: each warp decodes its ranks against a list of placeholders 0..255;
//     each output is then the index of its byte in the segment's unknown
//     start list, and the placeholder list left at the end is the
//     permutation P the segment applies. A CTA scans its permutations
//     (Q_j = P_0 o .. o P_j, a warp a row, 5 levels), composes the CTAs
//     before it into its own start list B, and maps every index through
//     B[Q_{j-1}[.]]. The prev rank at a segment's start is the input rank
//     before it.
//   - M: the list at any step is the bytes touched so far, most recent
//     first, then the untouched ones in identity order; under MTF-1 the head
//     h comes first and is left out of that order. Under MTF a byte is
//     touched when it occurs; under MTF-1 also when a swap pushes it off the
//     head (touching a byte while it is, or becomes, the head changes
//     nothing: the head is left out, and is touched again when it leaves).
//     Every warp records in a 256-entry table a segment the last step
//     touching each byte (shared atomicMax), a running max over the tables
//     (the cluster's earlier CTAs' first) gives each byte's last touch
//     before each segment, and each warp sorts the 256 keys (touch, 255 -
//     byte) descending (a bitonic network in its registers): that is the
//     start list.
//   - M under MTF-1 also needs h, and whether the previous rank was 0 (pz),
//     at each segment's start, and the heads that swaps push off. They come
//     from a three-register machine, state (h, T0 the entry at position 1,
//     pz), a byte b a step: b == h: pz = 1; else b == T0 and not pz: a swap
//     (T0 = old h, h = b, pz = 0, the old head touched); else T0 = b, pz = 0.
//     After a pair (b[p-1] == b[p] == a) and one more byte c, the state is
//     one of two that do not depend on what came before: (a, c, 0) (or
//     (a, -, 1) when c == a, T0 unread before it is overwritten), or
//     (c, a, 0), and h tells which. Before the first pair no step after the
//     first non-swap swaps, so h stays. So each warp finds its segment's
//     first pair, runs both continuations to the segment's end (lanes 0
//     and 1) and works out its tail (lanes 0 to 4, below); thread 0 of CTA 0
//     then walks the segments, each in a few steps, and last, each warp runs
//     its own segment from its now known start state to record the
//     pushed-off heads.
// The step of a segment is a warp's step over the list held in registers,
// split in two: the 32 positions at the front a lane each (lane l holds
// position l), the other 224 eight a lane in lanes 0..27 (a u64). A rank
// below 32 is one shuffle (decode) or one ballot (encode), and its move one
// shuffle up; a rank of 32 or more also reads the back by a shuffle or
// finds it by a zero-byte test and a ballot, and shifts the back's bytes up
// to r by one. Each step reads its input byte from the staged block and
// lane 0 writes its output byte in place.
//
// What bounds it: within a segment the steps are sequential, and the 32
// warps of a CTA share one SM's issue slots and shuffle unit, so a block
// takes about one segment's chain (2^15 / SEGS steps of about 20
// instructions, more for a rank of 32 or more) times the warps a scheduler
// runs, plus M's boundary work (the walk, the pushed-off heads, the sort);
// 32 blocks a MiB keep 128 of the 132 SMs busy. Latency- and issue-bound,
// not bytes.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int BLOCK = 1 << 15;     // MTF_BLOCK
constexpr int CLUSTER = 4;         // CTAs a block, a cluster
constexpr int WARPS = 32;          // segments a CTA
constexpr int SEGS = CLUSTER * WARPS;  // segments a block
constexpr int THREADS = WARPS * 32;
constexpr int HOT = 32;            // list positions held a lane each
constexpr int COLD_LANES = (256 - HOT) / 8;  // lanes holding the rest, 8 each
constexpr uint32_t FULL = 0xFFFFFFFFu;
constexpr uint64_t ONES = 0x0101010101010101ull;
constexpr uint64_t HIGHS = 0x8080808080808080ull;

// shared memory, each CTA: the block (input, then output, in place);
// WARPS + 2 rows of 256 bytes (row j: the list warp j starts from and ends
// with; N's CTA permutation and start list); the walk's u32s a segment of
// the block (Walk; CTA 0's are used); the CTA's 256 largest touches; then
// M's touch tables, WARPS x 256 u32, or N's second buffer of WARPS rows
constexpr int ROWS_AT = BLOCK;
constexpr int META_AT = ROWS_AT + (WARPS + 2) * 256;
constexpr int WALK = 13;  // the walk's u32s a segment (Walk)
constexpr int TOT_AT = META_AT + WALK * SEGS * 4;
constexpr int TOUCH_AT = TOT_AT + 256 * 4;
constexpr int smem_bytes(bool decode) { return TOUCH_AT + WARPS * 256 * (decode ? 1 : 4); }

// The walk's arrays a segment of the block: start state, first pair, the
// two continuations' end states, the tail's 4 keys and 5 end states.
struct Walk {
  uint32_t* starts;
  int* pairs;
  uint32_t *ends, *keys, *tails;
};
__device__ __forceinline__ Walk walk_at(uint32_t* w) {
  return {w, reinterpret_cast<int*>(w + SEGS), w + 2 * SEGS, w + 4 * SEGS, w + 8 * SEGS};
}

// a barrier of the block's CTAs (their shared memory writes seen by all)
__device__ __forceinline__ void sync_all() {
  if (CLUSTER > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// MTF-1's head machine, packed h | T0 << 10 | pz << 20 (h and T0 up to 10
// bits: a tail's 256 stands for the walk's h)
struct Head {
  uint32_t h, t0;
  bool pz;
};

__device__ __forceinline__ uint32_t pack(Head s) { return s.h | s.t0 << 10 | (uint32_t)s.pz << 20; }
__device__ __forceinline__ Head unpack(uint32_t v) {
  return {v & 0x3FFu, (v >> 10) & 0x3FFu, (v >> 20) != 0};
}

// one byte; -> whether it was a swap (s.t0 then holds the head it pushed off)
__device__ __forceinline__ bool head_step(Head& s, uint32_t b) {
  const bool eq = b == s.h;
  const bool sw = !eq && b == s.t0 && !s.pz;
  s.t0 = eq ? s.t0 : (sw ? s.h : b);
  s.h = sw ? b : s.h;
  s.pz = eq;
  return sw;
}

// Sorts the warp's 256 keys, key[k] of lane l the (8l + k)th, descending: a
// bitonic network, pairs within a lane compared in registers, across lanes
// through a shuffle.
__device__ __forceinline__ void sort_desc(uint32_t (&key)[8], int lane) {
#pragma unroll
  for (int k = 2; k <= 256; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = lane * 8 + e;
        const bool desc = (i & k) == 0;  // this run of k ends descending
        if (j >= 8) {
          const uint32_t other = __shfl_xor_sync(FULL, key[e], j >> 3);
          const bool keep_max = ((i & j) == 0) == desc;  // the lower index of a descending pair
          key[e] = keep_max ? max(key[e], other) : min(key[e], other);
        } else if ((e & j) == 0) {
          const uint32_t hi = max(key[e], key[e | j]), lo = min(key[e], key[e | j]);
          key[e] = desc ? hi : lo;
          key[e | j] = desc ? lo : hi;
        }
      }
    }
  }
}

// One segment's len steps from the list in row (all 256 positions) and
// previous rank prev, its bytes in place; the list left at the end back in
// row. The front's shuffles run every step, so only a rank of HOT or more
// branches.
template <bool DECODE, bool MTF1>
__device__ __forceinline__ void run_segment(uint8_t* bytes, int len, uint8_t* row, int prev,
                                            int lane) {
  uint32_t hot = row[lane];
  // positions HOT + 8l .. HOT + 8l + 7 in lane l < COLD_LANES, the lowest in
  // the low byte
  uint64_t cold = lane < COLD_LANES ? reinterpret_cast<const uint64_t*>(row + HOT)[lane] : 0ull;
#pragma unroll 4
  for (int i = 0; i < len; ++i) {
    const uint32_t v = bytes[i];
    uint32_t sym;
    int r;
    if (DECODE) {
      r = (int)v;
      sym = __shfl_sync(FULL, hot, r & (HOT - 1));
      if (r >= HOT) {
        const int q = r - HOT;
        sym = (uint32_t)(__shfl_sync(FULL, cold, q >> 3) >> (8 * (q & 7))) & 0xFFu;
      }
    } else {
      sym = v;
      const uint32_t m = __ballot_sync(FULL, hot == sym);
      r = __ffs(m) - 1;
      if (!m) {
        const uint64_t xo = cold ^ (sym * ONES);
        const uint64_t z = (xo - ONES) & ~xo & HIGHS;  // the lowest flag is exact
        const int src = __ffs(__ballot_sync(FULL, lane < COLD_LANES && z != 0)) - 1;
        const int byte = z ? (__ffsll((long long)z) - 1) >> 3 : 0;
        r = HOT + src * 8 + __shfl_sync(FULL, byte, src);
      }
    }
    const int dst = MTF1 ? (r > 1 ? 1 : (r == 1 && prev != 0 ? 0 : r)) : (r > 0 ? 0 : r);
    const uint32_t up = __shfl_up_sync(FULL, hot, 1);
    if (r >= HOT) {
      // (then dst < r) the positions HOT..r take their neighbour's byte,
      // HOT the front's last
      const uint64_t below = __shfl_up_sync(FULL, cold, 1);
      const uint32_t top = __shfl_sync(FULL, hot, HOT - 1);
      const uint64_t shifted = (cold << 8) | (lane ? below >> 56 : (uint64_t)top);
      const int b = min(r - HOT - 8 * lane, 7);  // bytes 0..b move
      if (b >= 0) {
        const uint64_t mk = b == 7 ? ~0ull : (1ull << (8 * b + 8)) - 1;
        cold = (cold & ~mk) | (shifted & mk);
      }
    }
    // with no move (dst == r < HOT) lane dst keeps its own entry
    hot = lane == dst ? sym : (lane > dst && lane <= r ? up : hot);
    prev = r;
    if (lane == 0) bytes[i] = (uint8_t)(DECODE ? sym : (uint32_t)r);
  }
  __syncwarp();
  row[lane] = (uint8_t)hot;
  if (lane < COLD_LANES) reinterpret_cast<uint64_t*>(row + HOT)[lane] = cold;
  __syncwarp();
}

// in, out [nb * BLOCK] u8 (in zero-padded past n); cluster b (CLUSTER CTAs)
// runs list block b, CTA c of it segments c * WARPS .. c * WARPS + WARPS - 1.
template <bool DECODE, bool MTF1>
__global__ void __launch_bounds__(THREADS, 1) mtf_kernel(const uint8_t* __restrict__ in,
                                                         uint8_t* __restrict__ out, long long n) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* data = smem;
  uint8_t* rows = smem + ROWS_AT;
  uint32_t* walk = reinterpret_cast<uint32_t*>(smem + META_AT);  // CTA 0's is the walk's
  uint32_t* tot = reinterpret_cast<uint32_t*>(smem + TOT_AT);
  uint32_t* touch = reinterpret_cast<uint32_t*>(smem + TOUCH_AT);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int crank = CLUSTER > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const long long base = (long long)(blockIdx.x / CLUSTER) * BLOCK;
  const int valid = n - base < BLOCK ? (int)(n - base) : BLOCK;
  const int seg = ((valid + SEGS - 1) / SEGS + 3) & ~3;  // a multiple of 4
  const int nseg = (valid + seg - 1) / seg;
  const int first = crank * WARPS, mine = max(0, min(WARPS, nseg - first));  // own segments
  const int g = first + warp;  // this warp's segment
  const int s0 = g * seg, len = min(seg, valid - s0), e = s0 + len;
  uint8_t* row = rows + warp * 256;
  // the walk's arrays, CTA 0's
  const Walk w0 = walk_at(CLUSTER > 1 ? cg::this_cluster().map_shared_rank(walk, 0) : walk);
  uint32_t* starts = w0.starts;
  int* pairs = w0.pairs;
  uint32_t* ends = w0.ends;
  uint32_t* keys = w0.keys;
  uint32_t* tails = w0.tails;

  for (int q = tid; q < (valid + 15) >> 4; q += THREADS)
    reinterpret_cast<uint4*>(data)[q] = reinterpret_cast<const uint4*>(in + base)[q];
  if (!DECODE)
    for (int q = tid; q < WARPS * 256; q += THREADS) touch[q] = 0;
  __syncthreads();

  int prev = 1;
  if (DECODE) {
    // the rank before the segment, from the input; placeholders 0..255
    if (g > 0 && len > 0) prev = in[base + s0 - 1];
    if (len > 0) {
      uint64_t id = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) id |= (uint64_t)(lane * 8 + i) << (8 * i);
      reinterpret_cast<uint64_t*>(row)[lane] = id;
      __syncwarp();
    }
  } else {
    if (MTF1 && len > 0) {
      // the segment's first pair (p - 1, p), and if p + 1 is still inside
      // it, its two continuations from step p + 2 to the end
      int p = -1;
      for (int q0 = s0 + 1; q0 < e; q0 += 32) {
        const int q = q0 + lane;
        const uint32_t m = __ballot_sync(FULL, q < e && data[q] == data[q - 1]);
        if (m) {
          p = q0 + __ffs(m) - 1;
          break;
        }
      }
      if (lane == 0) pairs[g] = p;
      const bool cont = p >= 0 && p < e - 1;
      uint32_t mine_end = 0;
      if (cont && lane < 2) {
        const uint32_t a = data[p], c = data[p + 1];
        Head s = lane == 0 || c == a ? Head{a, c, c == a} : Head{c, a, false};
        for (int i = p + 2; i < e; ++i) head_step(s, data[i]);
        ends[2 * g + lane] = mine_end = pack(s);
      }
      const uint32_t end_m = __shfl_sync(FULL, mine_end, 0), end_a = __shfl_sync(FULL, mine_end, 1);
      // the walk's shortcut: where the segment's first step does not swap
      // and its pair-free stretch is longer than 3, the walk's end state
      // depends on h alone, through at most 4 bytes (the tail: the stretch's
      // last two, and the pair's second and the byte after it, or the
      // segment's last): lane k < 4 runs the tail from h = tail byte k, lane
      // 4 from h = 256, a byte no tail holds (h and T0 of 256 in its end
      // state stand for the walk's h)
      const int end = p >= 0 ? p : e, t0 = end - 2, t1 = cont ? p + 2 : e;
      if (end - s0 > 3 && lane < 5) {
        const uint32_t h = lane < 4 ? (t0 + lane < t1 ? data[t0 + lane] : 0x3FFu) : 256u;
        if (lane < 4) keys[4 * g + lane] = h;
        Head s{h, h, true};
        for (int i = t0; i < t1; ++i) head_step(s, data[i]);
        if (cont) s = unpack(s.h == data[p] ? end_m : end_a);
        tails[5 * g + lane] = pack(s);
      }
    }
    // (each warp converged before a barrier: single lanes have run long
    // loops)
    __syncwarp();
    if (MTF1) sync_all();
    // thread 0 of CTA 0 walks the segments (MTF-1); the others fill each
    // segment's table of last occurrences (+1; 0: none), a step followed by
    // the same byte in its segment left to the later one
    const bool walker = MTF1 && crank == 0 && tid == 0;
    if (walker) {
      // in CTA 0's own shared memory (through the cluster's window each
      // access would take the longer remote path)
      const Walk w = walk_at(walk);
      Head s{0, 1, false};
      for (int j = 0; j < nseg; ++j) {
        w.starts[j] = pack(s);
        const int s0 = seg * j, e = min(s0 + seg, valid), p = w.pairs[j];
        const bool cont = p >= 0 && p < e - 1;  // p + 1 inside: a continuation
        if (cont && p - s0 <= 3) {
          // an early pair: from the state before step p - 1, the
          // continuation after the pair a a and then c is the second one
          // exactly when step p - 1 codes a at a rank >= 1 without a swap
          // and h == c (then step p swaps a in and step p + 1 swaps c back)
          for (int i = s0; i < p - 1; ++i) head_step(s, data[i]);
          const uint32_t a = data[p], c = data[p + 1];
          const bool alt = a != s.h && !(a == s.t0 && !s.pz) && s.h == c;
          s = unpack(w.ends[2 * j + (alt ? 1 : 0)]);
          continue;
        }
        const uint32_t b0 = data[s0];
        if ((p >= 0 ? p : e) - s0 > 3 && !(b0 != s.h && b0 == s.t0 && !s.pz)) {
          const uint32_t* kj = w.keys + 4 * j;
          const int k = s.h == kj[0] ? 0 : s.h == kj[1] ? 1 : s.h == kj[2] ? 2 : s.h == kj[3] ? 3 : 4;
          const Head t = unpack(w.tails[5 * j + k]);
          s = Head{t.h == 256u ? s.h : t.h, t.t0 == 256u ? s.h : t.t0, t.pz};
          continue;
        }
        // [s0, end) holds no pair: after its first step that is not a swap,
        // none of its steps swaps (a swap needs b == T0 with pz == 0, so
        // b == the byte before it, or the head the swap before pushed off),
        // so h is fixed there and the state after end - 1 follows from the
        // last two bytes
        const int end = p >= 0 ? p : e;
        int i = s0;
        while (i < end && head_step(s, data[i++])) {
        }
        if (end - i > 2) {
          s = Head{s.h, s.h, true};  // T0 unread: no swap with pz = 1
          i = end - 2;
        }
        for (; i < (cont ? p + 2 : e); ++i) head_step(s, data[i]);
        if (cont) s = unpack(w.ends[2 * j + (s.h == data[p] ? 0 : 1)]);
      }
    }
    const int lo = MTF1 && crank == 0 && warp == 0 ? 1 : 0;  // lane 0 may be walking
    if (lane >= lo) {
      for (int i = s0 + lane - lo; i < e; i += 32 - lo) {
        const uint32_t b = data[i];
        if (i + 1 == e || data[i + 1] != b) atomicMax(touch + warp * 256 + b, (uint32_t)(i + 1));
      }
    }
    __syncwarp();
    if (MTF1) {
      sync_all();
      // each segment from its start state: the heads its swaps push off
      if (lane == 0 && len > 0) {
        Head s = unpack(starts[g]);
        uint32_t* tj = touch + warp * 256;
        const uint32_t* d4 = reinterpret_cast<const uint32_t*>(data);
        for (int i = s0; i < e; i += 4) {  // s0 is a multiple of 4
          const uint32_t w = d4[i >> 2];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (head_step(s, (w >> (8 * k)) & 0xFFu) && i + k < e)
              atomicMax(tj + s.t0, (uint32_t)(i + k + 1));
        }
      }
      __syncwarp();
    }
    __syncthreads();
    // each byte's last touch before each segment: the CTA's own tables, then
    // the CTAs before it
    if (tid < 256) {
      uint32_t t = 0;
      for (int j = 0; j < mine; ++j) t = max(t, touch[j * 256 + tid]);
      tot[tid] = t;
    }
    sync_all();
    if (tid < 256) {
      uint32_t run = 0;
      for (int c = 0; c < crank; ++c)
        run = max(run, *cg::this_cluster().map_shared_rank(tot + tid, c));
      for (int j = 0; j < mine; ++j) {
        const uint32_t t = touch[j * 256 + tid];
        touch[j * 256 + tid] = run;
        run = max(run, t);
      }
    }
    __syncthreads();
    if (len > 0) {
      // the start list: the 256 keys (touch, 255 - byte) sorted descending
      // (the head's first, the untouched, touch 0, last in identity order),
      // a lane holding 8
      const uint32_t start = MTF1 ? starts[g] : 256u, head = MTF1 ? unpack(start).h : 256u;
      const uint32_t* tj = touch + warp * 256;
      uint32_t key[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t c = lane * 8 + k;
        key[k] = (c == head ? 0xFFFFFF00u : tj[c] << 8) | (255u - c);
      }
      sort_desc(key, lane);
      uint64_t lst = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) lst |= (uint64_t)(255u - (key[k] & 0xFFu)) << (8 * k);
      reinterpret_cast<uint64_t*>(row)[lane] = lst;
      __syncwarp();
      if (MTF1 && g > 0) prev = unpack(start).pz ? 0 : 1;
    }
  }

  if (len > 0) run_segment<DECODE, MTF1>(data + s0, len, row, prev, lane);
  __syncthreads();

  if (DECODE) {
    // warp 0 composes its segments' permutations (S_{j+1}[k] = S_j[P_j[k]]):
    // row j, P_j, becomes L_j, the list segment j starts with relative to
    // the CTA's first, and the scratch row the CTA's whole permutation T;
    // then the CTA's own start list B = T_0 o .. o T_{c-1} from the CTAs
    // before it
    uint8_t* t = rows + WARPS * 256;
    uint8_t* b = t + 256;
    uint64_t id = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) id |= (uint64_t)(lane * 8 + i) << (8 * i);
    // an inclusive scan of the rows, Q_j = P_0 o .. o P_j (Q(k) =
    // Q_{j-d}(Q_j(k)) at distance d = 1, 2, 4, ...), a warp a row, between
    // two buffers (the second in the space M's tables take)
    uint8_t* from = rows;
    uint8_t* to = smem + TOUCH_AT;
    for (int d = 1; d < WARPS; d <<= 1) {
      const uint64_t q = reinterpret_cast<const uint64_t*>(from + warp * 256)[lane];
      uint64_t nxt = q;
      if (warp >= d && warp < mine) {
        const uint8_t* lo = from + (warp - d) * 256;
        nxt = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) nxt |= (uint64_t)lo[(q >> (8 * i)) & 0xFFu] << (8 * i);
      }
      reinterpret_cast<uint64_t*>(to + warp * 256)[lane] = nxt;
      __syncthreads();
      uint8_t* x = from;
      from = to;
      to = x;
    }
    // segment j starts from Q_{j-1} (the CTA's first from the identity),
    // and the CTA's permutation T is Q of its last segment
    const uint64_t* q8 = reinterpret_cast<const uint64_t*>(from);
    const uint64_t qv = tid < 32 * (WARPS - 1) ? q8[tid] : 0ull;
    const uint64_t tv = mine > 0 ? q8[(mine - 1) * 32 + lane] : id;
    __syncthreads();
    if (tid < 32 * (WARPS - 1)) reinterpret_cast<uint64_t*>(rows)[32 + tid] = qv;
    if (warp == 0) {
      reinterpret_cast<uint64_t*>(rows)[lane] = id;
      reinterpret_cast<uint64_t*>(t)[lane] = tv;
    }
    sync_all();
    if (warp == 0) {
      reinterpret_cast<uint64_t*>(b)[lane] = id;
      __syncwarp();
      for (int c = 0; c < crank; ++c) {
        const uint64_t p = reinterpret_cast<const uint64_t*>(
            cg::this_cluster().map_shared_rank(t, c))[lane];
        uint64_t nxt = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) nxt |= (uint64_t)b[(p >> (8 * i)) & 0xFFu] << (8 * i);
        __syncwarp();
        reinterpret_cast<uint64_t*>(b)[lane] = nxt;
        __syncwarp();
      }
    }
    __syncthreads();
    // every index through its segment's start list, B[L_j[index]]
    uint32_t* d4 = reinterpret_cast<uint32_t*>(data);
    const int q1 = min(valid, (first + mine) * seg);
    for (int q = (first * seg + 3) / 4 + tid; q < (q1 + 3) / 4; q += THREADS) {
      const uint32_t w = d4[q];
      const uint8_t* lj = rows + (4 * q / seg - first) * 256;
      uint32_t o = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) o |= (uint32_t)b[lj[(w >> (8 * k)) & 0xFFu]] << (8 * k);
      d4[q] = o;
    }
  }
  // no CTA leaves while another may read its shared memory
  sync_all();

  // the CTA's own segments out
  const int q0 = first * seg / 16, q1 = (min(valid, (first + mine) * seg) + 15) / 16;
  for (int q = q0 + tid; q < q1 && mine > 0; q += THREADS)
    reinterpret_cast<uint4*>(out + base)[q] = reinterpret_cast<const uint4*>(data)[q];
}

template <bool DECODE, bool MTF1>
cudaError_t launch(const void* in, void* out, long long n, int nb, cudaStream_t stream) {
  constexpr int SMEM = smem_bytes(DECODE);
  cudaError_t err = cudaFuncSetAttribute(mtf_kernel<DECODE, MTF1>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb * CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = CLUSTER;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mtf_kernel<DECODE, MTF1>, (const uint8_t*)in, (uint8_t*)out, n);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t run(bool decode, const void* in, void* out, long long n, int nb, int mtf1,
                cudaStream_t stream) {
  if (n < 1 || nb != (int)((n + BLOCK - 1) / BLOCK)) return cudaErrorInvalidValue;
  if (decode) return mtf1 ? launch<true, true>(in, out, n, nb, stream)
                          : launch<true, false>(in, out, n, nb, stream);
  return mtf1 ? launch<false, true>(in, out, n, nb, stream)
              : launch<false, false>(in, out, n, nb, stream);
}

}  // namespace

// x [nb * 2^15] u8 zero-padded past n -> ranks [nb * 2^15] u8 (the first n
// meaningful); nb = ceil(n / 2^15). Returns the cudaError_t as an int.
extern "C" int ct_mtf_encode(const void* x, void* ranks, long long n, int nb, int mtf1,
                             void* stream) {
  return (int)run(false, x, ranks, n, nb, mtf1, (cudaStream_t)stream);
}

// ranks [nb * 2^15] u8 zero-padded past n -> bytes [nb * 2^15] u8.
extern "C" int ct_mtf_decode(const void* ranks, void* out, long long n, int nb, int mtf1,
                             void* stream) {
  return (int)run(true, ranks, out, n, nb, mtf1, (cudaStream_t)stream);
}
