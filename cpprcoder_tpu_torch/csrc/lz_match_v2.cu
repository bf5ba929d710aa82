// Kernel K: CT-LZ4's (SLZ4) v2 match table on Hopper.
//
// It replaces no Pallas kernel: the JAX package builds this table as XLA
// code in cpprcoder_tpu/ops/lz_ops.py, `_match_table_v2` (:589; its
// operands `_v2_operands` :540, the adjacent lcp `_alcp_sorted` :557): one
// 16-operand stable lax.sort of each segment, the neighbour pick in rank
// order, and a second sort back to position order. The spec is
// reference/slz4_ref.py (`match_table_v2`, a segment at a time); the plain
// version is ops/lz_ops.py `match_table`, which K equals exactly:
//   - each row's positions p < L (L = lens[row]) in the order of (the 16
//     bytes at p, big-endian, zero past L; p);
//   - al[k], the lcp of rank k with rank k - 1: the first differing byte
//     of the 32 bytes at each, or past 32 bytes the hash ladder (p = 5..11:
//     ext_p = H_p(. + 2^p) & 0xFFFF, ref_p = H_{p-1}(. + 2^p) & 0xFFFF,
//     H_{r+1}(i) = mix(H_r(i), H_r(i + 2^r)), H_0 the bytes); capped at
//     LCP_CAP and L - max(a, b); rank 0 gets 0;
//   - the pick at rank k of position p: the neighbours d = 1..4 up (length
//     the least al over the gap), then d = 1..2 down; a candidate c needs
//     c < p, p - c <= MAX_DISTANCE, c + 4 <= L and length >= 4, and only a
//     strictly longer one replaces the current one;
//   - (lcp, cand) stored at p; positions p >= L get (0, -1).
//
// What K uses of that order: a candidate needs a length of 4 or more, and
// two positions whose first 4 bytes (w0) differ have an lcp of 3 at most.
// So the pick reads only the order inside each group of equal w0, never
// the order between groups, and a position whose w0 occurs once in its row
// gets (0, -1). K orders each row's positions group by group (the groups
// in any order, the singletons left out) and sorts each group by (w1, w2,
// w3, p), its 16-byte key. A tail position p > L - 4 whose zero-padded w0
// repeats stays in its group: its lcp with any neighbour is capped below
// 4 (L - max(a, b)), so it stops a pick from reaching across it. A
// position whose 16 key bytes are all zero (runs of zeros) has the least
// key of its group (w0 = 0), and such positions tie but for p: they lead
// their group in position order and are placed there, not sorted.
//
// Launches, all rows in each, no host read (a task loop over the grid),
// their number fixed by W:
//   0. a memset: the hash table and the row counters;
//   1. count: a CTA counts a tile of 2,048 positions' w0 in a hash set in
//      shared memory (a warp's equal keys at once, by __match_any_sync),
//      then adds each of the tile's keys to its row's table once (2W slots
//      of (w0 << 32 | count), linear probing from a mixed w0, 64-bit CAS
//      and add in global memory), storing each position's slot and its
//      rank among its group's: a key that repeats all over a row costs an
//      atomic a tile, not one a position; the positions whose 16 key bytes
//      are zero stay out of the table, ranked in position order (a CTA
//      scan, the tile's count in meta);
//  1b. zero: a CTA a row sums the tiles' zero positions into their bases
//      and, with any, gives the group of w0 = 0 its range (the zero
//      positions first, then its others, which alone are sorted; a large
//      one's list entry covers the others) and clears its table slot;
//   2. alloc: over the table's slots, each group of 2 .. CAP positions gets
//      a range of the row's order from the bottom (a warp's groups by one
//      32-bit atomic), each larger one a range from the top and an entry
//      of the row's list of large groups (its first tile, offset, size);
//      a small group that crosses a CAP boundary of the order is recorded
//      there;
//   3. scatter: each position of a group writes its key (w1, w2, w3, p;
//      p's top bit on the group's first rank) at its group's offset plus
//      its rank (the zero positions straight to the order), and every
//      position whether it has a rank into lcp;
//   4. sort: a CTA sorts CAP = 4,096 keys: a tile of the small groups'
//      range (each group its own segment: the keys get the count of group
//      starts before them as their top field), or a tile of a large group;
//      8 keys a thread in registers (where W <= 2^20 each key packed into
//      16 bytes, else 20), then merge rounds in shared memory (padded: the
//      blocked stores are free of bank conflicts; the serial merge without
//      a branch), only as many rounds as the tile's keys need, and in a
//      round only the threads that hold keys of the one segment both runs
//      share merge;
//   5. fix: a CTA a CAP boundary merges the two sorted pieces of the small
//      group that crosses it, in place;
//   6. merge passes (log2(W / CAP) launches, runs of CAP, 2 CAP, ...)
//      inside each large group: a CTA takes MCHUNK outputs, cuts them from
//      the runs by a warp's 32-way merge path search on the keys in global
//      memory (no gather from the row), stages and merges them, and stores
//      them through shared memory; a CTA whose group is done exits, and a
//      group's last pass lands in the order;
//   7. al: the lcp of each rank with the one before it in its group, from
//      the keys (bytes 4..15) and the row (16..31); a pair equal on 32
//      bytes is left to the ladder and flags both positions' tiles;
//   8. the ladder, for the flagged 4,096-position tiles only: a CTA stages
//      the bytes from the tile's start to 4,096 past its end as u32s in
//      shared memory, builds H_1 .. H_11 in place and writes each
//      position's seven (ext_p << 16 | ref_p) as a 32-byte record;
//   9. the pick: a CTA 256 ranks stages their positions and those of 4
//      ranks before and 2 after, their al (the ladder's pairs from the
//      records), picks each rank's candidate and writes it at its
//      position packed in 4 bytes;
//  10. out: each position's (lcp, cand) as int64, in position order (the
//      singletons and p >= L: (0, -1)).
// Scratch (the wrapper's, lz_kernels.match_v2_scratch): the order and the
// merge buffer (16 bytes a position each), the hash table (16), the rows'
// counters, lists and flags, and each position's (slot, rank) (8); the
// ladder records reuse the merge buffer and the table, al and the pick's
// results the (slot, rank) words.
// Bound: bytes, on Z's basis (the rows read once, lcp and cand written:
// 17 bytes a position). What holds it back: the in-CTA sorts (9 merge
// rounds through shared memory at a full tile, each a dependent chain of
// loads), the merge passes of the large groups, the table's atomics and
// the scattered stores of the keys.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lz_common.cuh"
#include "lz_sort.cuh"

namespace {

constexpr int MIN_MATCH = 4;
constexpr int LCP_CAP = 4096;
constexpr int MAX_DISTANCE = 65535;
constexpr int EXACT = 32;           // bytes compared exactly before the ladder
constexpr int LADDER_LO = 5, LADDER_HI = 11;
constexpr int ITEMS = 8;            // keys a thread in the tile sort
constexpr int SORT_THREADS = 512;
constexpr int CAP = ITEMS * SORT_THREADS;  // keys a sort CTA; larger groups are merged
constexpr int SORT_BLOCKS = 65536 / (64 * SORT_THREADS);  // CTAs an SM: 64 registers a thread
constexpr int M_ITEMS = 8;          // keys a thread in the merge passes
constexpr int M_THREADS = 256;
constexpr int MCHUNK = M_ITEMS * M_THREADS;  // outputs a merge CTA
constexpr int GROUP_THREADS = 256;  // alloc, scatter, al, out
constexpr int COUNT_THREADS = 1024;
constexpr int COUNT_TILE = 2048;    // positions a count CTA
constexpr int COUNT_SLOTS = 2 * COUNT_TILE;  // its hash set of the tile's keys
constexpr int COUNT_SMEM = COUNT_SLOTS * 12 + COUNT_THREADS / 32 * 4;
constexpr int LADDER_TILE = 4096;
constexpr int LADDER_THREADS = 512;
constexpr int LADDER_SPAN = LADDER_TILE + LCP_CAP;  // the u32 hashes a ladder CTA keeps
constexpr int REC = 8;              // u32 words of a position's ladder record
constexpr int PICK = 256;           // ranks (and threads) a pick CTA
constexpr int MAX_GRID = 1 << 20;
constexpr uint32_t FIRST = 1u << 31;       // on p in the order: its group's first rank
constexpr uint32_t LADDER = 0xFFFFFFFFu;   // al: equal on 32 bytes, the ladder decides
constexpr uint32_t FULL = 0xFFFFFFFFu;
constexpr uint32_t ZERO = 0xFFFFFFFFu;     // a position's slot: its 16 key bytes are zero
constexpr uint32_t NONE = 0xFFFFFFFFu;

// A key of the merges: (w1, w2, w3, p), compared in that order.
struct K4 {
  uint4 v;
};

__device__ __forceinline__ bool operator<(const K4& a, const K4& b) {
  if (a.v.x != b.v.x) return a.v.x < b.v.x;
  if (a.v.y != b.v.y) return a.v.y < b.v.y;
  if (a.v.z != b.v.z) return a.v.z < b.v.z;
  return a.v.w < b.v.w;
}

// A key of the tile sort: the group's segment in the tile, then K4's.
struct K5 {
  uint32_t s;
  uint4 v;
};

__device__ __forceinline__ bool operator<(const K5& a, const K5& b) {
  if (a.s != b.s) return a.s < b.s;
  return K4{a.v} < K4{b.v};
}

// The row's counters and lists (u32 words, META_WORDS(w) a row): the small
// groups' fill, the large groups' fill, (large groups' tiles << 32 | their
// count), the zero group (offset, zero positions, others, the others'
// slot), the large groups' entries (first tile, offset, size, zero
// positions before them), the crossing small group of each CAP boundary
// (start, end; end 0: none), the ladder's tile flags, and each count
// tile's zero positions (then their exclusive sum).
struct Meta {
  uint32_t* base;
  int words, nt, nl;
  __device__ __forceinline__ uint32_t* row(long long r) const { return base + r * words; }
  __device__ __forceinline__ uint32_t* fill_small(long long r) const { return row(r); }
  __device__ __forceinline__ uint32_t* fill_large(long long r) const { return row(r) + 1; }
  __device__ __forceinline__ unsigned long long* large_count(long long r) const {
    return reinterpret_cast<unsigned long long*>(row(r) + 2);
  }
  __device__ __forceinline__ uint4* zero(long long r) const {
    return reinterpret_cast<uint4*>(row(r) + 4);
  }
  __device__ __forceinline__ uint4* large(long long r) const {
    return reinterpret_cast<uint4*>(row(r) + 8);
  }
  __device__ __forceinline__ uint2* cross(long long r) const {
    return reinterpret_cast<uint2*>(row(r) + 8 + 4 * nt);
  }
  __device__ __forceinline__ uint32_t* flags(long long r) const { return row(r) + 8 + 6 * nt; }
  __device__ __forceinline__ uint32_t* zeros(long long r) const {
    return row(r) + 8 + 6 * nt + nl;
  }
};

int meta_words(int w) {
  const int nt = (w + CAP - 1) / CAP, nl = (w + LADDER_TILE - 1) / LADDER_TILE;
  const int nc = (w + COUNT_TILE - 1) / COUNT_TILE;
  return (8 + 6 * nt + nl + nc + 3) & ~3;
}

__device__ __forceinline__ uint32_t be32(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

// The 16 bytes of a row at q, q + 1, .. (little-endian words), zero from L
// on. Where all 16 lie below L, two aligned 16-byte loads: each holds a
// byte below L, so neither leaves the row's pages.
__device__ __forceinline__ uint4 bytes16(const uint8_t* __restrict__ row, int L, int q) {
  if (q + 16 <= L) {
    const uint8_t* at = row + q;
    const int sh = (int)((uintptr_t)at & 15);
    const uint4* a4 = reinterpret_cast<const uint4*>(at - sh);
    const uint4 x = __ldg(a4);
    return sh ? ct::shift16(x, __ldg(a4 + 1), sh) : x;
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int b = 0; b < 16 && q + b < L; ++b) w[b >> 2] |= (uint32_t)row[q + b] << (8 * (b & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ int row_len(const long long* lens, long long row, int w) {
  return (int)max(0LL, min((long long)w, lens[row]));
}

// The table's home slot of a 4-byte key (murmur3's finalizer, scaled to S)
__device__ __forceinline__ uint32_t home_slot(uint32_t k, uint32_t S) {
  k ^= k >> 16;
  k *= 0x85EBCA6Bu;
  k ^= k >> 13;
  k *= 0xC2B2AE35u;
  k ^= k >> 16;
  return (uint32_t)(((unsigned long long)k * S) >> 32);
}

// Merge passes a group of g positions takes: runs of CAP, 2 CAP, .. < g.
__device__ __forceinline__ int passes_of(uint32_t g) {
  int k = 0;
  for (long long width = CAP; width < g; width *= 2) ++k;
  return k;
}

// The buffer that holds a large group after q of its passes: its last
// pass lands in the order.
__device__ __forceinline__ uint4* after(uint4* order, uint4* spare, uint32_t g, int q) {
  return ((passes_of(g) - q) & 1) ? spare : order;
}

// The large group whose tiles hold tile j of the row, or false
__device__ __forceinline__ bool large_of(const Meta& m, long long row, int j, uint4& e) {
  const unsigned long long c = *m.large_count(row);
  const int n = (int)(uint32_t)c;
  if (j >= (int)(c >> 32)) return false;
  const uint4* l = m.large(row);
  int lo = 0, hi = n - 1;  // the last entry whose first tile is <= j
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if ((int)l[mid].x <= j)
      lo = mid;
    else
      hi = mid - 1;
  }
  e = l[lo];
  return true;
}

// The slot of key k in a table of S slots of (k << 32 | count), and the
// count there before c more are added (linear probing from k's home slot;
// 64-bit CAS to claim a slot, 64-bit add to count).
__device__ __forceinline__ uint32_t table_add(unsigned long long* t, uint32_t S, uint32_t k,
                                              uint32_t c, uint32_t& before) {
  for (uint32_t slot = home_slot(k, S);; slot = slot + 1 == S ? 0 : slot + 1) {
    unsigned long long e = __ldcg(t + slot);
    if (e == 0) {
      e = atomicCAS(t + slot, 0ull, (unsigned long long)k << 32 | c);
      if (e == 0) {
        before = 0;
        return slot;
      }
    }
    if ((uint32_t)(e >> 32) == k) {
      before = (uint32_t)atomicAdd(t + slot, (unsigned long long)c);
      return slot;
    }
  }
}

// The exclusive sum of x over the CTA's THREADS threads, and the total
template <int THREADS>
__device__ __forceinline__ int cta_exclusive_sum(int x, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  int v = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) warp_sums[wi] = v;
  __syncthreads();
  if (wi == 0) {
    int u = lane < THREADS / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, u, o);
      if (lane >= o) u += y;
    }
    if (lane < THREADS / 32) warp_sums[lane] = u;
  }
  __syncthreads();
  total = warp_sums[THREADS / 32 - 1];
  return (wi ? warp_sums[wi - 1] : 0) + v - x;
}

// Whether the 16 key bytes at p are all zero (w0 = key, zero past L)
__device__ __forceinline__ bool zero_key(const uint8_t* __restrict__ r, int L, int p,
                                         uint32_t key) {
  if (key) return false;
  const uint4 b = bytes16(r, L, p);
  return (b.x | b.y | b.z | b.w) == 0;
}

// 1. each position's w0 into the row's table: its slot and rank. A CTA
// counts a tile of COUNT_TILE positions in a hash set in shared memory
// first (a warp's equal keys at once), then adds each of the tile's keys
// to the row's table once: a key that repeats all over the row is added
// once a tile, not once a position. A position whose 16 key bytes are all
// zero stays out of the table: its rank among them is its position order
// (the tile's count of them goes to meta, its rank in the tile to sr).
__global__ void __launch_bounds__(COUNT_THREADS)
    k_count(const uint8_t* __restrict__ rows, const long long* __restrict__ lens,
            unsigned long long* __restrict__ tab, uint2* __restrict__ sr, const Meta m, int w,
            int tiles, long long tasks) {
  constexpr int PER = COUNT_TILE / COUNT_THREADS;
  static_assert(PER == 2, "the zero positions' ranks pack two counts in a word");
  extern __shared__ unsigned long long skey[];  // 1 << 32 | key; then slot << 32 | base
  uint32_t* scnt = reinterpret_cast<uint32_t*>(skey + COUNT_SLOTS);
  int* warp_sums = reinterpret_cast<int*>(scnt + COUNT_SLOTS);
  const uint32_t S = 2u * (uint32_t)w;
  const unsigned lane = threadIdx.x & 31;
  for (long long task = blockIdx.x; task < tasks; task += gridDim.x) {
    const long long row = task / tiles;
    const int tile = (int)(task % tiles), t0 = tile * COUNT_TILE;
    const int L = row_len(lens, row, w);
    if (t0 >= L) continue;
    const uint8_t* r = rows + row * w;
    __syncthreads();  // the previous tile's reads are done
    for (int s = threadIdx.x; s < COUNT_SLOTS; s += COUNT_THREADS) {
      skey[s] = 0ull;
      scnt[s] = 0u;
    }
    __syncthreads();
    uint32_t at[PER], rank[PER];
    bool z[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int p = t0 + k * COUNT_THREADS + (int)threadIdx.x;
      uint32_t key = 0;
      z[k] = false;
      if (p < L) {
#pragma unroll
        for (int b = 0; b < 4; ++b) key = key << 8 | (p + b < L ? r[p + b] : 0u);
        z[k] = zero_key(r, L, p, key);
      }
      const unsigned live = __ballot_sync(FULL, p < L && !z[k]);
      if (p < L && !z[k]) {
        const unsigned peers = __match_any_sync(live, key);
        const int leader = __ffs(peers) - 1;
        uint32_t slot = 0, base = 0;
        if ((int)lane == leader) {
          const unsigned long long want = 1ull << 32 | key;
          for (slot = home_slot(key, COUNT_SLOTS);; slot = (slot + 1) & (COUNT_SLOTS - 1)) {
            unsigned long long e = skey[slot];
            if (e == 0) e = atomicCAS(&skey[slot], 0ull, want);
            if (e == 0 || e == want) break;
          }
          base = atomicAdd(&scnt[slot], (uint32_t)__popc(peers));
        }
        at[k] = __shfl_sync(live, slot, leader);
        rank[k] = __shfl_sync(live, base, leader) + __popc(peers & ((1u << lane) - 1u));
      }
    }
    // the zero positions' ranks in position order: both rounds' counts in
    // one sum (the first in the low 16 bits)
    int total;
    const int zx = cta_exclusive_sum<COUNT_THREADS>((int)z[0] | (int)z[1] << 16, warp_sums, total);
    if (threadIdx.x == 0) m.zeros(row)[tile] = (uint32_t)((total & 0xFFFF) + (total >> 16));
    rank[0] = z[0] ? (uint32_t)(zx & 0xFFFF) : rank[0];
    rank[1] = z[1] ? (uint32_t)((total & 0xFFFF) + (zx >> 16)) : rank[1];
    unsigned long long* t = tab + row * S;
    for (int s = threadIdx.x; s < COUNT_SLOTS; s += COUNT_THREADS) {
      const unsigned long long e = skey[s];
      if (e) {
        uint32_t before;
        const uint32_t slot = table_add(t, S, (uint32_t)e, scnt[s], before);
        skey[s] = (unsigned long long)slot << 32 | before;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int p = t0 + k * COUNT_THREADS + (int)threadIdx.x;
      if (p < L) {
        if (z[k]) {
          sr[row * w + p] = make_uint2(ZERO, rank[k]);
        } else {
          const unsigned long long e = skey[at[k]];
          sr[row * w + p] = make_uint2((uint32_t)(e >> 32), (uint32_t)e + rank[k]);
        }
      }
    }
  }
}

// 1b. the zero group, a CTA a row: the count tiles' zero positions summed
// into their bases; with any zero position, the group of w0 = 0 (the zero
// positions first, in position order, then the others, which alone are
// sorted) gets its range here, and its slot in the table is cleared for
// alloc.
__global__ void __launch_bounds__(COUNT_THREADS)
    k_zero(unsigned long long* __restrict__ tab, const Meta m, int w, int tiles) {
  __shared__ int warp_sums[COUNT_THREADS / 32];
  __shared__ int carry;
  const long long row = blockIdx.x;
  const uint32_t S = 2u * (uint32_t)w;
  uint32_t* zt = m.zeros(row);
  if (threadIdx.x == 0) carry = 0;
  for (int c0 = 0; c0 < tiles; c0 += COUNT_THREADS) {
    const int i = c0 + (int)threadIdx.x;
    const int x = i < tiles ? (int)zt[i] : 0;
    int total;
    const int ex = cta_exclusive_sum<COUNT_THREADS>(x, warp_sums, total);
    if (i < tiles) zt[i] = (uint32_t)(carry + ex);
    __syncthreads();
    if (threadIdx.x == 0) carry += total;
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  const uint32_t z = (uint32_t)carry;
  uint4 zi = make_uint4(0u, 0u, 0u, NONE);
  if (z > 0) {
    unsigned long long* t = tab + row * S;
    uint32_t others = 0;
    for (uint32_t slot = home_slot(0u, S);; slot = slot + 1 == S ? 0 : slot + 1) {
      const unsigned long long e = t[slot];
      if (e == 0) break;
      if ((e >> 32) == 0) {
        others = (uint32_t)e;
        zi.w = slot;
        t[slot] = 0ull;
        break;
      }
    }
    const uint32_t g = z + others;
    uint32_t off = 0;
    if (g >= 2 && g <= (uint32_t)CAP) {
      off = atomicAdd(m.fill_small(row), g);
      const uint32_t b = (off + g - 1) / CAP;
      if (b != off / CAP) m.cross(row)[b] = make_uint2(off, off + g);
    } else if (g > (uint32_t)CAP) {
      off = (uint32_t)w - atomicAdd(m.fill_large(row), g) - g;
      if (others > 0) {
        const uint32_t tiles_l = (others + CAP - 1) / CAP;
        const unsigned long long c =
            atomicAdd(m.large_count(row), (unsigned long long)tiles_l << 32 | 1ull);
        m.large(row)[(uint32_t)c] = make_uint4((uint32_t)(c >> 32), off + z, others, z);
      }
    }
    zi.x = off;
    zi.y = z;
    zi.z = others;
  }
  *m.zero(row) = zi;
}

// 2. each group of 2 or more positions its range of the row's order
__global__ void __launch_bounds__(GROUP_THREADS)
    k_alloc(unsigned long long* __restrict__ tab, const Meta m, int w, int chunks,
            long long tasks) {
  const uint32_t S = 2u * (uint32_t)w;
  const unsigned lane = threadIdx.x & 31;
  for (long long task = blockIdx.x; task < tasks; task += gridDim.x) {
    const long long row = task / chunks;
    const uint32_t s = (uint32_t)(task % chunks) * GROUP_THREADS + threadIdx.x;
    unsigned long long* t = tab + row * S + s;
    const unsigned long long e = s < S ? *t : 0ull;
    const uint32_t g = (uint32_t)e;
    const bool small = g >= 2 && g <= (uint32_t)CAP;
    // the warp's small groups side by side: one atomic
    uint32_t v = small ? g : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(FULL, v, o);
      if ((int)lane >= o) v += y;
    }
    const uint32_t total = __shfl_sync(FULL, v, 31);
    uint32_t base = 0;
    if (lane == 31 && total) base = atomicAdd(m.fill_small(row), total);
    base = __shfl_sync(FULL, base, 31);
    if (small) {
      const uint32_t off = base + v - g;
      *t = (unsigned long long)off << 32 | g;
      const uint32_t b = (off + g - 1) / CAP;
      if (b != off / CAP) m.cross(row)[b] = make_uint2(off, off + g);
    } else if (g > (uint32_t)CAP) {
      const uint32_t tiles = (g + CAP - 1) / CAP;
      const unsigned long long c =
          atomicAdd(m.large_count(row), (unsigned long long)tiles << 32 | 1ull);
      const uint32_t off = (uint32_t)w - atomicAdd(m.fill_large(row), g) - g;
      m.large(row)[(uint32_t)c] = make_uint4((uint32_t)(c >> 32), off, g, 0u);
      *t = (unsigned long long)off << 32 | g;
    }
  }
}

// 3. each grouped position's key at its place; into lcp, which the last
// launch replaces, 0 where a position has a rank and -1 where it has none
// (a singleton, or p >= L). The zero group's zero positions go straight to
// the order (their place is final), its others after them.
__global__ void __launch_bounds__(GROUP_THREADS)
    k_scatter(const uint8_t* __restrict__ rows, const long long* __restrict__ lens,
              const unsigned long long* __restrict__ tab, const uint2* __restrict__ sr,
              uint4* __restrict__ order, uint4* __restrict__ spare, long long* __restrict__ lcp_out,
              const Meta m, int w, int chunks, long long tasks) {
  const uint32_t S = 2u * (uint32_t)w;
  for (long long task = blockIdx.x; task < tasks; task += gridDim.x) {
    const long long row = task / chunks;
    const int p = (int)(task % chunks) * GROUP_THREADS + threadIdx.x;
    if (p >= w) continue;
    const int L = row_len(lens, row, w);
    const long long at = row * w + p;
    if (p < L) {
      const uint2 q = sr[at];
      const uint4 zi = *m.zero(row);
      uint32_t g, i;
      uint4* buf = order;
      bool first;
      if (q.x == ZERO) {
        g = zi.y + zi.z;
        i = zi.x + m.zeros(row)[p / COUNT_TILE] + q.y;
        first = i == zi.x;
      } else if (q.x == zi.w) {
        g = zi.y + zi.z;
        i = zi.x + zi.y + q.y;
        if (g > (uint32_t)CAP) buf = after(order, spare, zi.z, 0);
        first = false;
      } else {
        const unsigned long long e = tab[row * S + q.x];
        g = (uint32_t)e;
        i = (uint32_t)(e >> 32) + q.y;
        if (g > (uint32_t)CAP) buf = after(order, spare, g, 0);
        first = q.y == 0;
      }
      if (g >= 2) {
        const uint4 b = bytes16(rows + row * w, L, p);
        buf[row * w + i] =
            make_uint4(be32(b.y), be32(b.z), be32(b.w), (uint32_t)p | (first ? FIRST : 0u));
        lcp_out[at] = 0;
        continue;
      }
    }
    lcp_out[at] = -1;
  }
}

// Tile sort storage: the keys' 16-byte words as uint4, one pad an ITEMS
// (the blocked stores of ITEMS keys a thread meet no bank twice in a
// phase), and for the wide keys their segments as u32, one pad a 32.
__device__ __forceinline__ int padk(int i) { return i + i / ITEMS; }
__device__ __forceinline__ int pad32(int i) { return i + (i >> 5); }
constexpr int FIX_SMEM = (CAP + CAP / ITEMS) * 16;

// The tile sort's keys at any W: a K5 (segment, then (w1, w2, w3, p)), ITEMS
// a thread in CTAs of SORT_THREADS.
struct WideTile {
  static constexpr int ITEMS_T = ITEMS, THREADS = SORT_THREADS, BLOCKS = SORT_BLOCKS;
  static constexpr int SMEM = (CAP + CAP / ITEMS_T) * 16 + (CAP + CAP / 32) * 4;
  using T = K5;
  uint4* v;
  uint32_t* s;
  __device__ explicit WideTile(uint4* dyn)
      : v(dyn), s(reinterpret_cast<uint32_t*>(dyn + CAP + CAP / ITEMS_T)) {}
  static __device__ __forceinline__ int pad(int i) { return i + i / ITEMS_T; }
  static __device__ __forceinline__ T make(uint32_t seg, uint4 k) { return K5{seg, k}; }
  static __device__ __forceinline__ uint32_t seg(const T& t) { return t.s; }
  static __device__ __forceinline__ uint4 key(const T& t) { return t.v; }
  static __device__ __forceinline__ T last() {
    return K5{FULL, make_uint4(FULL, FULL, FULL, FULL)};
  }
  __device__ __forceinline__ void put(int i, const T& t) const {
    v[pad(i)] = t.v;
    s[pad32(i)] = t.s;
  }
  __device__ __forceinline__ T get(int i) const { return K5{s[pad32(i)], v[pad(i)]}; }
  __device__ __forceinline__ uint32_t seg_at(int i) const { return s[pad32(i)]; }
};

// The tile sort's keys where W <= 2^20: (segment, w1, w2, w3, p) packed in
// 128 bits (12, 32, 32, 32, 20: a tile's segments stay below 2^12, p below
// 2^20) and compared as a K4: one 16-byte load a key, ITEMS a thread in
// CTAs of SORT_THREADS, as the wide form.
static_assert(CAP <= 4096, "a tile's segments must fit the packed key's 12 bits");
struct PackedTile {
  static constexpr int ITEMS_T = ITEMS, THREADS = SORT_THREADS, BLOCKS = SORT_BLOCKS;
  static constexpr int SMEM = (CAP + CAP / ITEMS_T) * 16;
  using T = K4;
  uint4* v;
  __device__ explicit PackedTile(uint4* dyn) : v(dyn) {}
  static __device__ __forceinline__ int pad(int i) { return i + i / ITEMS_T; }
  static __device__ __forceinline__ T make(uint32_t seg, uint4 k) {
    return K4{make_uint4(seg << 20 | k.x >> 12, k.x << 20 | k.y >> 12, k.y << 20 | k.z >> 12,
                         k.z << 20 | k.w)};
  }
  static __device__ __forceinline__ uint32_t seg(const T& t) { return t.v.x >> 20; }
  static __device__ __forceinline__ uint4 key(const T& t) {
    return make_uint4(t.v.x << 12 | t.v.y >> 20, t.v.y << 12 | t.v.z >> 20,
                      t.v.z << 12 | t.v.w >> 20, t.v.w & 0xFFFFFu);
  }
  static __device__ __forceinline__ T last() { return K4{make_uint4(FULL, FULL, FULL, FULL)}; }
  __device__ __forceinline__ void put(int i, const T& t) const { v[pad(i)] = t.v; }
  __device__ __forceinline__ T get(int i) const { return K4{v[pad(i)]}; }
  __device__ __forceinline__ uint32_t seg_at(int i) const { return v[pad(i)].x >> 20; }
};

template <class Tile>
struct TileRun {
  const Tile& t;
  int at;
  __device__ __forceinline__ typename Tile::T operator[](int i) const { return t.get(at + i); }
};

// ct::serial_merge of two runs of one array (load(k): its key k; a0, b0:
// the runs' starts), without a branch: every step loads the next key of
// the run it took from by a selected index (a spent run's last), so a
// warp's lanes stay together.
template <class Load, class T, int N>
__device__ __forceinline__ void flat_merge(const Load& load, int a0, int a_len, int b0, int b_len,
                                           int i, int j, T (&out)[N]) {
  // a spent or empty run's index stays on a key of the array
  const int any = a_len > 0 ? a0 : b_len > 0 ? b0 : 0;
  const int a_last = a_len > 0 ? a0 + a_len - 1 : any, b_last = b_len > 0 ? b0 + b_len - 1 : any;
  T x = load(min(a0 + i, a_last)), y = load(min(b0 + j, b_last));
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const bool take_b = j < b_len && (i >= a_len || y < x);
    out[k] = take_b ? y : x;
    i += !take_b;
    j += take_b;
    const T z = load(take_b ? min(b0 + j, b_last) : min(a0 + i, a_last));
    x = take_b ? x : z;
    y = take_b ? z : y;
  }
}

template <class Tile>
struct TileLoad {
  const Tile& t;
  __device__ __forceinline__ typename Tile::T operator()(int k) const { return t.get(k); }
};

struct ArrayLoad {
  const K4* a;
  __device__ __forceinline__ K4 operator()(int k) const { return a[k]; }
};

struct PaddedLoad {
  const uint4* a;
  __device__ __forceinline__ K4 operator()(int k) const { return K4{a[padk(k)]}; }
};

struct SharedK4 {
  const uint4* v;
  int at;
  __device__ __forceinline__ K4 operator[](int i) const { return K4{v[padk(at + i)]}; }
};

struct GlobalK4 {
  const uint4* v;
  __device__ __forceinline__ K4 operator[](int i) const {
    uint4 x = v[i];
    x.w &= ~FIRST;
    return K4{x};
  }
};

// A bitonic network over a thread's keys (distinct: any network sorts them)
template <int N, class T>
__device__ __forceinline__ void reg_sort(T (&it)[N]) {
#pragma unroll
  for (int k = 2; k <= N; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1)
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int l = i ^ j;
        if (l > i) {
          const bool up = (i & k) == 0;
          if (up ? it[l] < it[i] : it[i] < it[l]) {
            const T t = it[i];
            it[i] = it[l];
            it[l] = t;
          }
        }
      }
}

// 4. sort a tile: of the small groups' range (task j < nt) or of a large
// group (task nt + its tile)
template <class Tile>
__global__ void __launch_bounds__(Tile::THREADS, Tile::BLOCKS)
    k_sort(uint4* __restrict__ order, uint4* __restrict__ spare, const Meta m, int w,
           long long tasks) {
  using T = typename Tile::T;
  constexpr int IT = Tile::ITEMS_T, TH = Tile::THREADS;
  extern __shared__ uint4 dyn[];
  const Tile sh(dyn);
  __shared__ int warp_sums[TH / 32];
  const int per_row = w > CAP ? 3 * m.nt : m.nt;
  const int t0 = IT * (int)threadIdx.x;
  for (long long task = blockIdx.x; task < tasks; task += gridDim.x) {
    const long long row = task / per_row;
    const int j = (int)(task % per_row);
    uint4* io;
    int cnt;
    if (j < m.nt) {
      cnt = min(CAP, (int)*m.fill_small(row) - j * CAP);
      io = order + row * w + (long long)j * CAP;
    } else {
      uint4 e;
      if (!large_of(m, row, j - m.nt, e)) continue;
      const int k = j - m.nt - (int)e.x;
      cnt = min(CAP, (int)e.z - k * CAP);
      io = after(order, spare, e.z, 0) + row * w + e.y + (long long)k * CAP;
    }
    if (cnt <= 0) continue;
    __syncthreads();  // the previous task's reads of shared memory are done
    for (int i = threadIdx.x; i < cnt; i += TH) dyn[Tile::pad(i)] = io[i];
    __syncthreads();
    // each key's segment: the group starts at or before it in the tile
    int starts = 0;
#pragma unroll
    for (int k = 0; k < IT; ++k)
      if (t0 + k < cnt) starts += (int)(dyn[Tile::pad(t0 + k)].w >> 31);
    int seg_total;
    int seg = cta_exclusive_sum<TH>(starts, warp_sums, seg_total);
    T it[IT];
#pragma unroll
    for (int k = 0; k < IT; ++k) {
      if (t0 + k < cnt) {
        uint4 v = dyn[Tile::pad(t0 + k)];
        seg += (int)(v.w >> 31);
        v.w &= ~FIRST;
        it[k] = Tile::make((uint32_t)seg, v);
      } else {
        it[k] = Tile::last();
      }
    }
    reg_sort(it);
    int n = IT;  // the rounds a tile of cnt keys needs
    while (n < cnt) n <<= 1;
    // runs of up to WARP_KEYS lie in one warp's keys: a warp barrier holds
    // them; a CTA barrier where the last round's or this round's pairs
    // reach past a warp's keys
    constexpr int WARP_KEYS = 32 * IT;
    for (int width = IT; width < n; width <<= 1) {
      if (width > WARP_KEYS)
        __syncthreads();
      else
        __syncwarp();
      if (t0 < n) {
#pragma unroll
        for (int k = 0; k < IT; ++k) sh.put(t0 + k, it[k]);
      }
      if (2 * width > WARP_KEYS)
        __syncthreads();
      else
        __syncwarp();
      if (t0 < n) {
        const int gs = t0 & ~(2 * width - 1), d = t0 - gs;
        // Segments order the keys first, so only a segment that both runs
        // hold moves: a thread whose keys all lie before it (in the first
        // run) or after it (in the second) keeps them where they are.
        const uint32_t sa = sh.seg_at(gs + width - 1), sb = sh.seg_at(gs + width);
        if (sa == sb && (d < width ? Tile::seg(it[IT - 1]) == sa : Tile::seg(it[0]) == sb)) {
          const TileRun<Tile> a{sh, gs}, b{sh, gs + width};
          const int i = ct::merge_path(a, width, b, width, d);
          flat_merge(TileLoad<Tile>{sh}, gs, width, gs + width, width, i, d - i, it);
        }
      }
    }
    __syncthreads();
    if (t0 < n) {
#pragma unroll
      for (int k = 0; k < IT; ++k) sh.put(t0 + k, it[k]);
    }
    __syncthreads();
    // a group's first rank in the tile: its segment differs from the one
    // before (the tile's first: from 0, the crossing group's)
    for (int i = threadIdx.x; i < cnt; i += TH) {
      const T t = sh.get(i);
      uint4 v = Tile::key(t);
      if (Tile::seg(t) != (i ? sh.seg_at(i - 1) : 0u)) v.w |= FIRST;
      io[i] = v;
    }
  }
}

// 5. merge the two pieces of the small group that crosses each CAP
// boundary of the order, in place
__global__ void __launch_bounds__(SORT_THREADS, SORT_BLOCKS)
    k_fix(uint4* __restrict__ order, const Meta m, int w, long long tasks) {
  extern __shared__ uint4 dyn[];
  for (long long task = blockIdx.x; task < tasks; task += gridDim.x) {
    const long long row = task / m.nt;
    const int b = (int)(task % m.nt);
    const uint2 c = m.cross(row)[b];
    if (c.y == 0) continue;
    const int cnt = (int)(c.y - c.x), na = b * CAP - (int)c.x;
    uint4* io = order + row * w + c.x;
    __syncthreads();
    for (int i = threadIdx.x; i < cnt; i += SORT_THREADS) {
      uint4 v = io[i];
      v.w &= ~FIRST;
      dyn[padk(i)] = v;
    }
    __syncthreads();
    const int d = min(ITEMS * (int)threadIdx.x, cnt);
    const SharedK4 x{dyn, 0}, y{dyn, na};
    const int i = ct::merge_path(x, na, y, cnt - na, d);
    K4 out[ITEMS];
    flat_merge(PaddedLoad{dyn}, 0, na, na, cnt - na, i, d - i, out);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (d + k < cnt) {
        uint4 v = out[k].v;
        if (d + k == 0) v.w |= FIRST;
        io[d + k] = v;
      }
    }
  }
}

// 6. one merge pass inside the large groups: runs of `width` into 2 width
__global__ void __launch_bounds__(M_THREADS)
    k_merge(uint4* __restrict__ order, uint4* __restrict__ spare, const Meta m, int w,
            long long tasks, int width, int pass) {
  __shared__ K4 sh[MCHUNK];
  __shared__ int cut[2];
  constexpr int SUB = CAP / MCHUNK;
  const int per_row = 2 * m.nt * SUB;
  for (long long task = blockIdx.x; task < tasks; task += gridDim.x) {
    const long long row = task / per_row;
    const int j = (int)(task % per_row) / SUB, sub = (int)(task % per_row) % SUB;
    uint4 e;
    if (!large_of(m, row, j, e)) continue;
    const int g = (int)e.z;
    const int c0 = (j - (int)e.x) * CAP + sub * MCHUNK;
    if (c0 >= g || g <= width) continue;
    const int gs = c0 / (2 * width) * (2 * width);
    const int a_len = min(width, g - gs), b_len = max(0, min(2 * width, g - gs) - width);
    const int d0 = c0 - gs, d1 = min(c0 + MCHUNK, g) - gs;
    const uint4* src = after(order, spare, e.z, pass) + row * w + e.y + gs;
    uint4* dst = after(order, spare, e.z, pass + 1) + row * w + e.y + gs;
    const GlobalK4 a{src}, b{src + width};
    __syncthreads();  // the previous task's reads of sh and cut are done
    if (threadIdx.x < 64) {
      const int c = ct::warp_merge_path(a, a_len, b, b_len, threadIdx.x < 32 ? d0 : d1);
      if ((threadIdx.x & 31) == 0) cut[threadIdx.x >> 5] = c;
    }
    __syncthreads();
    const int i0 = cut[0], na = cut[1] - i0, j0 = d0 - i0, nb = d1 - cut[1] - j0;
    const int cnt = na + nb;
    for (int k = threadIdx.x; k < cnt; k += M_THREADS)
      sh[k] = k < na ? a[i0 + k] : b[j0 + k - na];
    __syncthreads();
    const int d = min(M_ITEMS * (int)threadIdx.x, cnt);
    const int i = ct::merge_path(sh, na, sh + na, nb, d);
    K4 out[M_ITEMS];
    flat_merge(ArrayLoad{sh}, 0, na, na, nb, i, d - i, out);
    __syncthreads();  // every thread's reads of sh are done: the outputs go through it
#pragma unroll
    for (int k = 0; k < M_ITEMS; ++k)
      if (d + k < cnt) sh[d + k] = out[k];
    __syncthreads();
    for (int k = threadIdx.x; k < cnt; k += M_THREADS) {
      uint4 v = sh[k].v;
      if (d0 + k == 0 && gs == 0 && e.w == 0) v.w |= FIRST;
      dst[d0 + k] = v;
    }
  }
}

__device__ __forceinline__ bool in_order(int i, int w, uint32_t small, uint32_t large) {
  return i < (int)small || (i < w && i >= w - (int)large);
}

// the first differing byte of x and y (little-endian words), or -1
__device__ __forceinline__ int first_diff(uint4 x, uint4 y) {
  const uint32_t d[4] = {x.x ^ y.x, x.y ^ y.y, x.z ^ y.z, x.w ^ y.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (d[k]) return 4 * k + ((__ffs(d[k]) - 1) >> 3);
  return -1;
}

// 7. al of each rank with the one before it in its group (0 at a group's
// first rank); LADDER where 32 bytes are equal and the ladder decides
__global__ void __launch_bounds__(GROUP_THREADS)
    k_al(const uint8_t* __restrict__ rows, const long long* __restrict__ lens,
         const uint4* __restrict__ order, uint32_t* __restrict__ al, const Meta m, int w,
         int chunks, long long tasks) {
  for (long long task = blockIdx.x; task < tasks; task += gridDim.x) {
    const long long row = task / chunks;
    const int i = (int)(task % chunks) * GROUP_THREADS + threadIdx.x;
    if (!in_order(i, w, *m.fill_small(row), *m.fill_large(row))) continue;
    const uint4* o = order + row * w;
    const uint4 y = o[i];
    uint32_t l = 0;
    if (!(y.w & FIRST)) {
      const uint4 x = o[i - 1];
      const int a = (int)(x.w & ~FIRST), b = (int)y.w;
      const int L = row_len(lens, row, w), room = max(L - max(a, b), 0);
      const uint32_t d[3] = {x.x ^ y.x, x.y ^ y.y, x.z ^ y.z};
      int f = -1;
#pragma unroll
      for (int k = 2; k >= 0; --k)
        if (d[k]) f = 4 + 4 * k + (__clz(d[k]) >> 3);
      if (f < 0) {
        const uint8_t* r = rows + row * w;
        f = first_diff(bytes16(r, L, a + 16), bytes16(r, L, b + 16));
        if (f >= 0) f += 16;
      }
      if (f >= 0) {
        l = (uint32_t)min(f, room);
      } else if (room <= EXACT) {
        l = (uint32_t)room;
      } else {
        l = LADDER;
        uint32_t* fl = m.flags(row);
        fl[a / LADDER_TILE] = 1u;
        fl[b / LADDER_TILE] = 1u;
      }
    }
    al[row * w + i] = l;
  }
}

__device__ __forceinline__ uint32_t mix(uint32_t a, uint32_t b) {
  const uint32_t h = a * 0x9E3779B1u + b * 0x85EBCA77u;
  return (h ^ (h >> 15)) * 0x27D4EB2Fu;
}

// 8. the ladder records of the flagged tiles: word p - 5 = ext_p << 16 |
// ref_p
__global__ void __launch_bounds__(LADDER_THREADS)
    k_ladder(const uint8_t* __restrict__ rows, const long long* __restrict__ lens,
             uint32_t* __restrict__ rec, const Meta m, int w, int tiles, long long tasks) {
  constexpr int PER = LADDER_SPAN / LADDER_THREADS;  // hashes a thread builds a round
  constexpr int OWN = LADDER_TILE / LADDER_THREADS;  // positions a thread records
  constexpr int NLAD = LADDER_HI - LADDER_LO + 1;
  __shared__ uint32_t h[LADDER_SPAN];
  for (long long task = blockIdx.x; task < tasks; task += gridDim.x) {
    const long long row = task / tiles;
    const int tile = (int)(task % tiles);
    if (!m.flags(row)[tile]) continue;
    const int t0 = tile * LADDER_TILE;
    const int L = row_len(lens, row, w);
    const int cnt = min(LADDER_TILE, L - t0);
    if (cnt <= 0) continue;
    const uint8_t* r = rows + row * w;
    __syncthreads();  // the previous tile's reads are done
    for (int j = threadIdx.x; j < LADDER_SPAN; j += LADDER_THREADS)
      h[j] = t0 + j < L ? r[t0 + j] : 0u;
    uint32_t lad[OWN][NLAD];
#pragma unroll
    for (int k = 0; k < OWN; ++k)
#pragma unroll
      for (int q = 0; q < NLAD; ++q) lad[k][q] = 0u;
    // h[j] = H_s(t0 + j), right for j <= LADDER_SPAN - 2^s (the bytes it
    // covers are staged); H_s(i + 2^p) is read for s <= p <= 11 only.
#pragma unroll
    for (int s = 0; s < LADDER_HI; ++s) {
      uint32_t v[PER];
      __syncthreads();
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int j = (int)threadIdx.x + k * LADDER_THREADS;
        v[k] = mix(h[j], j + (1 << s) < LADDER_SPAN ? h[j + (1 << s)] : 0u);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < PER; ++k) h[threadIdx.x + k * LADDER_THREADS] = v[k];
      __syncthreads();
      const int p1 = s + 1;  // h is H_{p1}: ext_{p1}, and ref_{p1 + 1}
#pragma unroll
      for (int k = 0; k < OWN; ++k) {
        const int i = (int)threadIdx.x + k * LADDER_THREADS;
        if (p1 >= LADDER_LO) lad[k][p1 - LADDER_LO] |= (h[i + (1 << p1)] & 0xFFFFu) << 16;
        if (p1 + 1 >= LADDER_LO && p1 + 1 <= LADDER_HI)
          lad[k][p1 + 1 - LADDER_LO] |= h[i + (1 << (p1 + 1))] & 0xFFFFu;
      }
    }
#pragma unroll
    for (int k = 0; k < OWN; ++k) {
      const int i = (int)threadIdx.x + k * LADDER_THREADS;
      if (i < cnt) {
        uint4* o = reinterpret_cast<uint4*>(rec + (row * w + t0 + i) * REC);
        o[0] = make_uint4(lad[k][0], lad[k][1], lad[k][2], lad[k][3]);
        o[1] = make_uint4(lad[k][4], lad[k][5], lad[k][6], 0u);
      }
    }
  }
}

// the ladder's lcp of positions a and b (equal on their first 32 bytes)
__device__ int ladder_lcp(const uint32_t* __restrict__ rec, int L, int a, int b) {
  const uint4* ra = reinterpret_cast<const uint4*>(rec + (long long)a * REC);
  const uint4* rb = reinterpret_cast<const uint4*>(rec + (long long)b * REC);
  const uint4 a0 = ra[0], a1 = ra[1], b0 = rb[0], b1 = rb[1];
  const uint32_t x[7] = {a0.x ^ b0.x, a0.y ^ b0.y, a0.z ^ b0.z, a0.w ^ b0.w,
                         a1.x ^ b1.x, a1.y ^ b1.y, a1.z ^ b1.z};
  int l = EXACT;
#pragma unroll
  for (int q = 0; q < 7; ++q) {
    const int p = LADDER_LO + q;
    if ((x[q] >> 16) == 0) {
      l = 1 << (p + 1);
    } else {
      if ((x[q] & 0xFFFFu) == 0) l += 1 << (p - 1);
      break;
    }
  }
  return min(min(l, LCP_CAP), max(L - max(a, b), 0));
}

// 9. the pick: lcp << 16 | (p - cand) at each ranked position p, 4 bytes
// (0: no candidate; lcp <= LCP_CAP and p - cand <= MAX_DISTANCE)
__global__ void __launch_bounds__(PICK)
    k_pick(const long long* __restrict__ lens, const uint4* __restrict__ order,
           const uint32_t* __restrict__ al_in, const uint32_t* __restrict__ rec,
           uint32_t* __restrict__ res, const Meta m, int w, int chunks, long long tasks) {
  __shared__ int ps[PICK + 6];  // the positions of ranks k0 - 4 .. k0 + PICK + 1 (-1: none)
  __shared__ int al[PICK + 5];  // al of ranks k0 - 3 .. k0 + PICK + 1
  for (long long task = blockIdx.x; task < tasks; task += gridDim.x) {
    const long long row = task / chunks;
    const int k0 = (int)(task % chunks) * PICK;
    const uint32_t small = *m.fill_small(row), large = *m.fill_large(row);
    if (k0 >= (int)small && k0 + PICK <= w - (int)large) continue;
    const int L = row_len(lens, row, w);
    const uint4* o = order + row * w;
    const uint32_t* a_in = al_in + row * w;
    __syncthreads();  // the previous task's reads are done
    for (int e = threadIdx.x; e < PICK + 6; e += PICK) {
      const int k = k0 - 4 + e;
      ps[e] = k >= 0 && in_order(k, w, small, large) ? (int)(o[k].w & ~FIRST) : -1;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < PICK + 5; e += PICK) {
      const int k = k0 - 3 + e;
      uint32_t l = k >= 0 && in_order(k, w, small, large) ? a_in[k] : 0u;
      if (l == LADDER) l = (uint32_t)ladder_lcp(rec + row * w * REC, L, ps[e], ps[e + 1]);
      al[e] = (int)l;
    }
    __syncthreads();
    const int t = threadIdx.x, k = k0 + t;
    if (!in_order(k, w, small, large)) continue;
    const int p = ps[t + 4];
    int bl = 0, bc = -1, len = 1 << 30;
#pragma unroll
    for (int d = 1; d <= 6; ++d) {
      // up d = 1..4: the least al of ranks k - d + 1 .. k; down d - 4 =
      // 1..2: of ranks k + 1 .. k + d - 4
      int c;
      if (d <= 4) {
        len = min(len, al[t + 4 - d]);
        c = ps[t + 4 - d];
      } else {
        if (d == 5) len = 1 << 30;
        len = min(len, al[t + d - 1]);
        c = ps[t + d];
      }
      if (c >= 0 && c < p && p - c <= MAX_DISTANCE && c + MIN_MATCH <= L && len >= MIN_MATCH &&
          len > bl) {
        bl = len;
        bc = c;
      }
    }
    res[row * w + p] = bc < 0 ? 0u : (uint32_t)bl << 16 | (uint32_t)(p - bc);
  }
}

// 10. (lcp, cand) of each position from the pick's result, or (0, -1)
// where the scatter found no rank
__global__ void __launch_bounds__(GROUP_THREADS)
    k_out(const uint32_t* __restrict__ res, long long* __restrict__ lcp_out,
          long long* __restrict__ cand_out, int w, int chunks, long long tasks) {
  for (long long task = blockIdx.x; task < tasks; task += gridDim.x) {
    const long long row = task / chunks;
    const int p = (int)(task % chunks) * GROUP_THREADS + threadIdx.x;
    if (p >= w) continue;
    const long long at = row * w + p;
    const uint32_t v = lcp_out[at] < 0 ? 0u : res[at];
    lcp_out[at] = v >> 16;
    cand_out[at] = v ? p - (long long)(v & 0xFFFFu) : -1;
  }
}

int grid_of(long long tasks) { return (int)(tasks < MAX_GRID ? tasks : MAX_GRID); }

}  // namespace

// rows uint8 [n, w] (row i's lens[i] bytes, zero past them), lens int64
// [n] -> lcp, cand int64 [n, w]: the v2 match table. scratch (16-byte
// aligned; lz_kernels.match_v2_scratch: 14 u32 a position and 16 + 7 *
// ceil(w / 2,048) a row are enough): the order, the merge buffer, the
// hash table (2w slots a row), the rows' counters, lists and flags
// (meta_words(w) a row), the (slot, rank) pairs.
extern "C" int ct_lz_match_v2(const void* rows, const void* lens, void* lcp, void* cand,
                              void* scratch, int n, int w, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (n < 1 || w < 1 || w > (1 << 30)) return (int)cudaErrorInvalidValue;
  const long long nw = (long long)n * w;
  uint4* order = (uint4*)scratch;
  uint4* spare = order + nw;
  unsigned long long* tab = (unsigned long long*)(spare + nw);
  const int nt = (w + CAP - 1) / CAP;
  const int nl = (w + LADDER_TILE - 1) / LADDER_TILE;
  const Meta m{(uint32_t*)(tab + 2 * nw), meta_words(w), nt, nl};
  uint2* sr = (uint2*)(m.base + (long long)n * m.words);
  uint32_t* rec = (uint32_t*)spare;  // after the merges: the spare buffer and the table
  uint32_t* al = (uint32_t*)sr;      // after the scatter, and the pick's results
  uint32_t* res = al + nw;
  const uint8_t* r = (const uint8_t*)rows;
  const long long* ln = (const long long*)lens;
  long long* lo = (long long*)lcp;
  long long* co = (long long*)cand;
  const long long chunks = (w + GROUP_THREADS - 1) / GROUP_THREADS;
  const long long ctiles = (w + COUNT_TILE - 1) / COUNT_TILE;
  const long long slot_chunks = (2LL * w + GROUP_THREADS - 1) / GROUP_THREADS;
  cudaError_t e = cudaMemsetAsync(tab, 0, 16 * nw + 4LL * n * m.words, st);
  if (e != cudaSuccess) return (int)e;
  if ((e = cudaFuncSetAttribute(k_count, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                COUNT_SMEM)) != cudaSuccess)
    return (int)e;
  k_count<<<grid_of(n * ctiles), COUNT_THREADS, COUNT_SMEM, st>>>(r, ln, tab, sr, m, w,
                                                                  (int)ctiles, n * ctiles);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  k_zero<<<n, COUNT_THREADS, 0, st>>>(tab, m, w, (int)ctiles);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  k_alloc<<<grid_of(n * slot_chunks), GROUP_THREADS, 0, st>>>(tab, m, w, (int)slot_chunks,
                                                              n * slot_chunks);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  k_scatter<<<grid_of(n * chunks), GROUP_THREADS, 0, st>>>(r, ln, tab, sr, order, spare, lo, m,
                                                           w, (int)chunks, n * chunks);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const long long sorts = (long long)n * (w > CAP ? 3 * nt : nt);
  if (w <= (1 << 20)) {
    if ((e = cudaFuncSetAttribute(k_sort<PackedTile>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  PackedTile::SMEM)) != cudaSuccess)
      return (int)e;
    k_sort<PackedTile><<<grid_of(sorts), PackedTile::THREADS, PackedTile::SMEM, st>>>(
        order, spare, m, w, sorts);
  } else {
    if ((e = cudaFuncSetAttribute(k_sort<WideTile>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  WideTile::SMEM)) != cudaSuccess)
      return (int)e;
    k_sort<WideTile><<<grid_of(sorts), WideTile::THREADS, WideTile::SMEM, st>>>(order, spare, m,
                                                                               w, sorts);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if ((e = cudaFuncSetAttribute(k_fix, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                FIX_SMEM)) != cudaSuccess)
    return (int)e;
  k_fix<<<grid_of((long long)n * nt), SORT_THREADS, FIX_SMEM, st>>>(order, m, w,
                                                                    (long long)n * nt);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const long long merge_tasks = (long long)n * 2 * nt * (CAP / MCHUNK);
  int pass = 0;
  for (long long width = CAP; width < w; width *= 2, ++pass) {
    k_merge<<<grid_of(merge_tasks), M_THREADS, 0, st>>>(order, spare, m, w, merge_tasks,
                                                        (int)width, pass);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  k_al<<<grid_of(n * chunks), GROUP_THREADS, 0, st>>>(r, ln, order, al, m, w, (int)chunks,
                                                      n * chunks);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int ltiles = (w + LADDER_TILE - 1) / LADDER_TILE;
  k_ladder<<<grid_of((long long)n * ltiles), LADDER_THREADS, 0, st>>>(r, ln, rec, m, w, ltiles,
                                                                      (long long)n * ltiles);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const long long pchunks = (w + PICK - 1) / PICK;
  k_pick<<<grid_of(n * pchunks), PICK, 0, st>>>(ln, order, al, rec, res, m, w, (int)pchunks,
                                                n * pchunks);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  k_out<<<grid_of(n * chunks), GROUP_THREADS, 0, st>>>(res, lo, co, w, (int)chunks, n * chunks);
  return (int)cudaGetLastError();
}
