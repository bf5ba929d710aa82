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
// (The plain version also sorts the positions past L, after every real
// one: they get (0, -1), and no real position takes one of them as its
// candidate or gets a length over 0 through them, so K leaves them out.)
//
// Launches, all rows in each, no host read (a task loop over the grid):
//   1. the tiles: a CTA sorts TILE = 2,048 positions of a row by their
//      keys (the 16 bytes loaded from the row, the position), in registers
//      and then by merge rounds in shared memory (lz_sort.cuh), and writes
//      the positions in rank order;
//   2. the ladder: a CTA a tile of 4,096 positions stages the bytes from
//      the tile's start to 4,096 past its end as u32s in shared memory,
//      builds H_1 .. H_11 in place (11 rounds), and writes each position's
//      seven (ext_p << 16 | ref_p) as a 32-byte record;
//   3. log2(W / TILE) merge passes, runs of 2,048, 4,096, ... positions:
//      a CTA takes 2,048 outputs of a pair of runs, finds where they start
//      and end in both runs by a warp's 32-way merge path search (the keys
//      loaded from the row), stages them with their keys in shared memory,
//      and merges them, ITEMS a thread;
//   4. the pick: a CTA 256 ranks stages their positions and those of 4
//      ranks before and 2 after, computes al of its ranks (and 3 before and
//      2 after: the up and down gaps) from the row's bytes and, past 32
//      equal bytes, the ladder records, picks each rank's candidate and
//      stores (lcp, cand) straight at its position; the positions past L
//      get (0, -1) there too.
// Scratch (the wrapper's, 40 bytes a position): the ladder records and
// two rank orders (u32).
// Bound: bytes, on Z's basis (the rows read once, lcp and cand written:
// 17 bytes a position). What holds it back: the merge passes (each reads
// and writes the rank order and loads every key from the row again), the
// ladder records (32 bytes a position written, read where ranks tie past
// 32 bytes), and the pick's scattered stores.

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
constexpr int ITEMS = 8;            // keys a thread in the sort and the merges
constexpr int SORT_THREADS = 256;
constexpr int TILE = ITEMS * SORT_THREADS;  // positions a sort CTA, outputs a merge CTA
constexpr int LADDER_TILE = 4096;
constexpr int LADDER_THREADS = 512;
constexpr int LADDER_SPAN = LADDER_TILE + LCP_CAP;  // the u32 hashes a ladder CTA keeps
constexpr int REC = 8;              // u32 words of a position's ladder record
constexpr int PICK = 256;           // ranks (and threads) a pick CTA
constexpr int MAX_GRID = 1 << 20;

// A position's sort key: the 16 bytes at p as big-endian words, then p.
struct Key {
  uint32_t w0, w1, w2, w3, p;
};

__device__ __forceinline__ bool operator<(const Key& a, const Key& b) {
  const unsigned long long a0 = (unsigned long long)a.w0 << 32 | a.w1;
  const unsigned long long b0 = (unsigned long long)b.w0 << 32 | b.w1;
  if (a0 != b0) return a0 < b0;
  const unsigned long long a1 = (unsigned long long)a.w2 << 32 | a.w3;
  const unsigned long long b1 = (unsigned long long)b.w2 << 32 | b.w3;
  if (a1 != b1) return a1 < b1;
  return a.p < b.p;
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

__device__ __forceinline__ Key key_at(const uint8_t* __restrict__ row, int L, uint32_t p) {
  const uint4 b = bytes16(row, L, (int)p);
  return Key{be32(b.x), be32(b.y), be32(b.z), be32(b.w), p};
}

// The key of rank i of a run of positions
struct RankKeys {
  const uint32_t* perm;
  const uint8_t* row;
  int L;
  __device__ __forceinline__ Key operator[](int i) const { return key_at(row, L, perm[i]); }
};

__device__ __forceinline__ int row_len(const long long* lens, long long row, int w) {
  return (int)max(0LL, min((long long)w, lens[row]));
}

// 1. sort each tile of TILE positions
__global__ void __launch_bounds__(SORT_THREADS)
    k_sort_tiles(const uint8_t* __restrict__ rows, const long long* __restrict__ lens,
                 uint32_t* __restrict__ perm, int w, int tiles, long long tasks) {
  __shared__ Key sh[TILE];
  for (long long task = blockIdx.x; task < tasks; task += gridDim.x) {
    const long long row = task / tiles;
    const int t0 = (int)(task % tiles) * TILE;
    const int L = row_len(lens, row, w);
    const int cnt = min(TILE, L - t0);
    if (cnt <= 0) continue;
    const uint8_t* r = rows + row * w;
    Key it[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int i = ITEMS * (int)threadIdx.x + k;
      it[k] = i < cnt ? key_at(r, L, (uint32_t)(t0 + i))
                      : Key{0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu};
    }
    ct::block_sort(it, sh);
    uint32_t* out = perm + row * w + t0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int i = ITEMS * (int)threadIdx.x + k;
      if (i < cnt) out[i] = it[k].p;
    }
  }
}

__device__ __forceinline__ uint32_t mix(uint32_t a, uint32_t b) {
  const uint32_t h = a * 0x9E3779B1u + b * 0x85EBCA77u;
  return (h ^ (h >> 15)) * 0x27D4EB2Fu;
}

// 2. each position's ladder record: word p - 5 = ext_p << 16 | ref_p
__global__ void __launch_bounds__(LADDER_THREADS)
    k_ladder(const uint8_t* __restrict__ rows, const long long* __restrict__ lens,
             uint32_t* __restrict__ rec, int w, int tiles, long long tasks) {
  constexpr int PER = LADDER_SPAN / LADDER_THREADS;  // hashes a thread builds a round
  constexpr int OWN = LADDER_TILE / LADDER_THREADS;  // positions a thread records
  constexpr int NLAD = LADDER_HI - LADDER_LO + 1;
  __shared__ uint32_t h[LADDER_SPAN];
  for (long long task = blockIdx.x; task < tasks; task += gridDim.x) {
    const long long row = task / tiles;
    const int t0 = (int)(task % tiles) * LADDER_TILE;
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

// 3. one merge pass: runs of `width` ranks into runs of 2 * width
__global__ void __launch_bounds__(SORT_THREADS)
    k_merge(const uint8_t* __restrict__ rows, const long long* __restrict__ lens,
            const uint32_t* __restrict__ src, uint32_t* __restrict__ dst, int w, int chunks,
            long long tasks, int width) {
  __shared__ Key sh[TILE];
  __shared__ int cut[2];
  for (long long task = blockIdx.x; task < tasks; task += gridDim.x) {
    const long long row = task / chunks;
    const int c0 = (int)(task % chunks) * TILE;
    const int L = row_len(lens, row, w);
    if (c0 >= L) continue;
    const int gs = c0 / (2 * width) * (2 * width);
    const int a_len = min(width, L - gs), b_len = max(0, min(2 * width, L - gs) - width);
    const int d0 = c0 - gs, d1 = min(c0 + TILE, L) - gs;
    const uint8_t* r = rows + row * w;
    const RankKeys a{src + row * w + gs, r, L}, b{src + row * w + gs + width, r, L};
    __syncthreads();  // the previous task's reads of sh and cut are done
    if (threadIdx.x < 64) {
      const int c = ct::warp_merge_path(a, a_len, b, b_len, threadIdx.x < 32 ? d0 : d1);
      if ((threadIdx.x & 31) == 0) cut[threadIdx.x >> 5] = c;
    }
    __syncthreads();
    const int i0 = cut[0], na = cut[1] - i0, j0 = d0 - i0, nb = d1 - cut[1] - j0;
    const int cnt = na + nb;
    for (int e = threadIdx.x; e < cnt; e += SORT_THREADS)
      sh[e] = e < na ? a[i0 + e] : b[j0 + e - na];
    __syncthreads();
    const int d = min(ITEMS * (int)threadIdx.x, cnt);
    const int i = ct::merge_path(sh, na, sh + na, nb, d);
    Key out[ITEMS];
    ct::serial_merge(sh, na, sh + na, nb, i, d - i, out);
    uint32_t* o = dst + row * w + c0 + d;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      if (d + k < cnt) o[k] = out[k].p;
  }
}

// the first differing byte of x and y (little-endian words), or -1
__device__ __forceinline__ int first_diff(uint4 x, uint4 y) {
  const uint32_t d[4] = {x.x ^ y.x, x.y ^ y.y, x.z ^ y.z, x.w ^ y.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (d[k]) return 4 * k + ((__ffs(d[k]) - 1) >> 3);
  return -1;
}

// the v2 lcp of positions a and b (both below L)
__device__ int pair_lcp(const uint8_t* __restrict__ row, const uint32_t* __restrict__ rec,
                        int L, int a, int b) {
  int l = first_diff(bytes16(row, L, a), bytes16(row, L, b));
  if (l < 0) {
    l = first_diff(bytes16(row, L, a + 16), bytes16(row, L, b + 16));
    if (l >= 0) l += 16;
  }
  if (l < 0) {
    const uint4* ra = reinterpret_cast<const uint4*>(rec + (long long)a * REC);
    const uint4* rb = reinterpret_cast<const uint4*>(rec + (long long)b * REC);
    const uint4 a0 = ra[0], a1 = ra[1], b0 = rb[0], b1 = rb[1];
    const uint32_t x[7] = {a0.x ^ b0.x, a0.y ^ b0.y, a0.z ^ b0.z, a0.w ^ b0.w,
                           a1.x ^ b1.x, a1.y ^ b1.y, a1.z ^ b1.z};
    l = EXACT;
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
    l = min(l, LCP_CAP);
  }
  return min(l, max(L - max(a, b), 0));
}

// 4. the pick, scattered to position order
__global__ void __launch_bounds__(PICK)
    k_pick(const uint8_t* __restrict__ rows, const long long* __restrict__ lens,
           const uint32_t* __restrict__ perm, const uint32_t* __restrict__ rec,
           long long* __restrict__ lcp_out, long long* __restrict__ cand_out, int w, int chunks,
           long long tasks) {
  __shared__ int ps[PICK + 6];  // the positions of ranks k0 - 4 .. k0 + PICK + 1 (-1: none)
  __shared__ int al[PICK + 5];  // al of ranks k0 - 3 .. k0 + PICK + 1
  for (long long task = blockIdx.x; task < tasks; task += gridDim.x) {
    const long long row = task / chunks;
    const int k0 = (int)(task % chunks) * PICK;
    const int L = row_len(lens, row, w);
    const uint8_t* r = rows + row * w;
    const uint32_t* pr = perm + row * w;
    __syncthreads();  // the previous task's reads are done
    for (int e = threadIdx.x; e < PICK + 6; e += PICK) {
      const int k = k0 - 4 + e;
      ps[e] = k >= 0 && k < L ? (int)pr[k] : -1;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < PICK + 5; e += PICK) {
      const int k = k0 - 3 + e;
      al[e] = k >= 1 && k < L ? pair_lcp(r, rec + row * w * REC, L, ps[e], ps[e + 1]) : 0;
    }
    __syncthreads();
    const int t = threadIdx.x, k = k0 + t;
    if (k >= w) continue;
    int bl = 0, bc = -1, at = k;
    if (k < L) {
      const int p = ps[t + 4];
      at = p;
      int len = 1 << 30;
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
    }
    lcp_out[row * w + at] = bl;
    cand_out[row * w + at] = bc;
  }
}

int grid_of(long long tasks) { return (int)(tasks < MAX_GRID ? tasks : MAX_GRID); }

}  // namespace

// rows uint8 [n, w] (row i's lens[i] bytes, zero past them), lens int64
// [n] -> lcp, cand int64 [n, w]: the v2 match table. scratch: 10 * n * w
// u32 (16-byte aligned): the ladder records, then two rank orders.
extern "C" int ct_lz_match_v2(const void* rows, const void* lens, void* lcp, void* cand,
                              void* scratch, int n, int w, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (n < 1 || w < 1 || w > (1 << 30)) return (int)cudaErrorInvalidValue;
  const long long nw = (long long)n * w;
  uint32_t* rec = (uint32_t*)scratch;
  uint32_t* src = rec + REC * nw;
  uint32_t* dst = src + nw;
  const uint8_t* r = (const uint8_t*)rows;
  const long long* ln = (const long long*)lens;
  const int tiles = (w + TILE - 1) / TILE;
  cudaError_t e;
  k_sort_tiles<<<grid_of((long long)n * tiles), SORT_THREADS, 0, st>>>(r, ln, src, w, tiles,
                                                                        (long long)n * tiles);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int ltiles = (w + LADDER_TILE - 1) / LADDER_TILE;
  k_ladder<<<grid_of((long long)n * ltiles), LADDER_THREADS, 0, st>>>(r, ln, rec, w, ltiles,
                                                                      (long long)n * ltiles);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  for (long long width = TILE; width < w; width *= 2) {
    k_merge<<<grid_of((long long)n * tiles), SORT_THREADS, 0, st>>>(
        r, ln, src, dst, w, tiles, (long long)n * tiles, (int)width);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    uint32_t* t = src;
    src = dst;
    dst = t;
  }
  const int chunks = (w + PICK - 1) / PICK;
  k_pick<<<grid_of((long long)n * chunks), PICK, 0, st>>>(
      r, ln, src, rec, (long long*)lcp, (long long*)cand, w, chunks, (long long)n * chunks);
  return (int)cudaGetLastError();
}
