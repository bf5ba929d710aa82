// Kernel Z: CT-LZ4's (SLZ4) v1 match table on Hopper.
//
// It replaces no Pallas kernel: the JAX package builds this table as XLA
// code in cpprcoder_tpu/ops/lz_ops.py, `_candidates` (:81-100, one stable
// lax.sort of (flag, key, position) a segment and the adjacent rank) and
// `_lcp_estimate` (:103-124, two u32 hash chains compared over descending
// spans: an estimate that can only be too high, clamped after the walk).
// The spec is reference/slz4_ref.py (`parse_segment`); this table is the
// oracle's, exact:
//   cand[p] = the largest j < p with j + 4 <= L and the same 4 bytes as p,
//             for p + 4 <= L, if p - j <= MAX_DISTANCE; else -1;
//   lcp[p]  = the common prefix of the bytes at j and at p (overlap
//             allowed), capped at LCP_CAP and L - p, where cand[p] >= 0;
//             else 0.
// Its plain version is ops/lz_ops.py `match_table_v1`.
//
// The distance rule makes the search local: the nearest earlier equal key
// is within MAX_DISTANCE exactly when some equal key is. One launch, a CTA
// a tile of up to TILE = 4,096 positions of a segment (tiles independent,
// so any W up to 2^30 spreads over the card: kennedy.xls's 8 segments of
// 2^17 are 256 CTAs), each CTA:
//   1. stages the row's bytes from MAX_DISTANCE before the tile to LCP_CAP
//      past it in shared memory (at most 73,727 bytes);
//   2. keys the tile's indexable positions into a shared hash set of exact
//      32-bit keys (linear probing, load at most 1/2, a 64-bit slot claimed
//      by atomicCAS: the key above, an occupied bit below; no key is
//      dropped): each position gets its key's slot;
//   3. scans the window before the tile once, from the top down, taking a
//      key's last position there into its slot's `last` by a 32-bit
//      atomicMax, after a load, so a run of one key costs one wave of
//      atomics. (A first design kept the position in the slot's low word:
//      a 64-bit shared atomicMax is a compare-and-swap loop, which a run
//      of one byte turned into a spin. Its 70,000 zeros took 0.181 ms.)
//   4. sorts the tile's (slot, position) pairs, 25 bits in a u32, by the
//      block merge sort K shares (lz_sort.cuh: 4 keys a thread sorted in
//      registers, then 10 merge rounds through shared memory, 20 barriers
//      at a full tile where a bitonic sort takes 78): a position's nearest
//      earlier equal key is its rank neighbour where the slots agree, else
//      its slot's last position before the tile; then the distance rule;
//   5. the exact lcp by chains: where cand[p] = cand[p - 1] + 1 both share
//      their first mismatch (the 4 bytes at every position of the chain
//      match), so a warp takes 32 positions, finds by a ballot the last
//      position of each chain among them (lane 31 ends every chain that
//      goes on), and compares bytes once a chain, from 4 past that end up
//      to LCP_CAP past it: the end's lane alone for 16 bytes, then, where
//      no mismatch came, the warp, 128 bytes a round (4 a lane, funnel
//      shifts of aligned shared words, the first mismatch by a ballot);
//      each position takes its chain's mismatch by a shuffle. A first
//      design compared from every thread's first position (a run of one
//      byte: 1,024 compares of 4,096 bytes a tile);
//   6. writes lcp and cand (int64, the walk's interface) coalesced.
// Bound: bytes (the rows read once, lcp and cand written: 17 bytes a
// position). What holds it back: step 3's 65,535 probes and step 4's
// merge rounds a tile, in one CTA a SM (216 KiB of shared memory).

#include <cuda_runtime.h>
#include <stdint.h>

#include "lz_common.cuh"
#include "lz_sort.cuh"

namespace {

constexpr int MIN_MATCH = 4;
constexpr int LCP_CAP = 4096;
constexpr int MAX_DISTANCE = 65535;
constexpr int TILE = 4096;             // positions a CTA (12 bits in a sort key)
constexpr int THREADS = 1024;
constexpr int POS_BITS = 12;
constexpr uint32_t PAST = 0xFFFFFFFFu;  // a sort key after every slot
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int LANE_BYTES = 16;          // step 5: a lane's compare before the warp's
constexpr int ITEMS = 4;                // step 4: keys a thread (THREADS * ITEMS = TILE)

// 4 bytes at byte offset o of the staged window (little-endian)
__device__ __forceinline__ uint32_t ld4(const uint32_t* w, int o) {
  return __funnelshift_r(w[o >> 2], w[(o >> 2) + 1], 8 * (o & 3));
}

__device__ __forceinline__ int slot_of(uint32_t k, int bits) {
  return (int)((k * 2654435761u) >> (32 - bits));
}

__global__ void __launch_bounds__(THREADS)
    match_v1_kernel(const uint8_t* __restrict__ rows, const long long* __restrict__ lens,
                    long long* __restrict__ lcp_out, long long* __restrict__ cand_out, int w,
                    int tile, int tiles, long long tasks, int sort_n, int hash_bits,
                    int win_bytes) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int hs = 1 << hash_bits;
  const uint32_t* win = reinterpret_cast<const uint32_t*>(smem);
  unsigned long long* slot = reinterpret_cast<unsigned long long*>(smem + win_bytes);
  int* last = reinterpret_cast<int*>(slot + hs);
  uint32_t* order = reinterpret_cast<uint32_t*>(last + hs);
  int* cand_t = reinterpret_cast<int*>(order + sort_n);
  int* lcp_t = cand_t + tile;
  for (long long task = blockIdx.x; task < tasks; task += gridDim.x) {
    const long long row = task / tiles;
    const int t0 = (int)(task % tiles) * tile;
    const int tn = min(tile, w - t0);
    const long long L = lens[row];
    const long long at = row * (long long)w + t0;
    // the tile's indexable positions (p + 4 <= L) are its first idx_n
    const int idx_n = (int)max(0LL, min((long long)tn, L - MIN_MATCH + 1 - t0));
    if (idx_n == 0) {
      for (int i = threadIdx.x; i < tn; i += blockDim.x) {
        cand_out[at + i] = -1;
        lcp_out[at + i] = 0;
      }
      continue;
    }
    const int b0 = max(0, t0 - MAX_DISTANCE);
    const int b1 = min(w, t0 + tn + LCP_CAP);
    __syncthreads();  // the previous tile's reads of shared memory are done
    // 1. the bytes
    ct::stage(smem, rows + (at - t0) + b0, b1 - b0);
    for (int i = threadIdx.x; i < hs; i += blockDim.x) {
      slot[i] = 0;
      last[i] = -1;
    }
    __syncthreads();

    // 2. the tile's keys into the hash set; order[i] = slot << 12 | i
    for (int i = threadIdx.x; i < sort_n; i += blockDim.x) {
      uint32_t v = PAST;
      if (i < idx_n) {
        const uint32_t k = ld4(win, t0 + i - b0);
        int s = slot_of(k, hash_bits);
        const unsigned long long mine = (unsigned long long)k << 32 | 1u;
        for (;;) {
          unsigned long long cur = slot[s];
          if (cur == 0) {
            cur = atomicCAS(&slot[s], 0ull, mine);
            if (cur == 0) break;
          }
          if (cur == mine) break;
          s = (s + 1) & (hs - 1);
        }
        v = ((uint32_t)s << POS_BITS) | (uint32_t)i;
      }
      order[i] = v;
    }
    __syncthreads();

    // 3. each tile key's last position in the window before the tile (all
    // indexable: j + 4 <= t0 + 3 < L)
    for (int j = t0 - 1 - (int)threadIdx.x; j >= b0; j -= (int)blockDim.x) {
      const uint32_t k = ld4(win, j - b0);
      int s = slot_of(k, hash_bits);
      const unsigned long long mine = (unsigned long long)k << 32 | 1u;
      for (unsigned long long cur; (cur = slot[s]) != 0; s = (s + 1) & (hs - 1)) {
        if (cur == mine) {
          if (last[s] < j) atomicMax(&last[s], j);
          break;
        }
      }
    }

    // 4. sort (slot, position), then each position's nearest earlier key
    {
      uint32_t it[ITEMS];
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) it[k] = order[ITEMS * threadIdx.x + k];
      ct::block_sort(it, order);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) order[ITEMS * threadIdx.x + k] = it[k];
    }
    __syncthreads();
    for (int r = threadIdx.x; r < idx_n; r += blockDim.x) {
      const uint32_t v = order[r];
      const int i = (int)(v & (TILE - 1));
      int c;
      if (r > 0 && (order[r - 1] >> POS_BITS) == (v >> POS_BITS))
        c = t0 + (int)(order[r - 1] & (TILE - 1));
      else
        c = last[v >> POS_BITS];
      cand_t[i] = c >= 0 && t0 + i - c <= MAX_DISTANCE ? c : -1;
    }
    for (int i = idx_n + threadIdx.x; i < tn; i += blockDim.x) cand_t[i] = -1;
    __syncthreads();

    // 5. the exact lcp by chains, a warp 32 positions at a time (every lane
    // of a warp runs the same trips)
    const int lane = threadIdx.x & 31;
    for (int g = threadIdx.x & ~31; g < tn; g += blockDim.x) {
      const int i = g + lane, p = t0 + i;
      const int c = i < tn ? cand_t[i] : -1;
      // the chain's last position among these 32
      const bool end = c >= 0 && !(lane < 31 && i + 1 < tn && cand_t[i + 1] == c + 1);
      int q = p + MIN_MATCH, d = p - c, lim = 0, mm = 0;
      bool more = false;
      if (end) {
        lim = (int)min(L, (long long)p + LCP_CAP);
        mm = lim;
        for (int r = 0; r < LANE_BYTES / 4 && q < lim; ++r, q += 4) {
          const uint32_t x = ld4(win, q - b0) ^ ld4(win, q - d - b0);
          if (x) {
            mm = min(q + ((__ffs(x) - 1) >> 3), lim);
            break;
          }
        }
        more = mm == lim && q < lim;
      }
      for (unsigned todo = __ballot_sync(FULL, more); todo; todo &= todo - 1) {
        const int src = __ffs(todo) - 1;
        const int q0 = __shfl_sync(FULL, q, src), dd = __shfl_sync(FULL, d, src);
        const int lm = __shfl_sync(FULL, lim, src);
        int found = lm;
        for (int k = q0; k < lm; k += 128) {
          const int at4 = k + 4 * lane;
          const uint32_t x = at4 < lm ? ld4(win, at4 - b0) ^ ld4(win, at4 - dd - b0) : 0u;
          const unsigned hit = __ballot_sync(FULL, x != 0);
          if (hit) {
            const int h = __ffs(hit) - 1;
            const uint32_t xh = __shfl_sync(FULL, x, h);
            found = min(k + 4 * h + ((__ffs(xh) - 1) >> 3), lm);
            break;
          }
        }
        if (lane == src) mm = found;
      }
      // each position's chain ends at the first end at or after it
      const unsigned after = __ballot_sync(FULL, end) & (FULL << lane);
      const int e_mm = __shfl_sync(FULL, mm, after ? __ffs(after) - 1 : 0);
      if (i < tn)
        lcp_t[i] = c >= 0 ? min((int)min((long long)LCP_CAP, L - p), e_mm - p) : 0;
    }
    __syncthreads();

    // 6. out
    for (int i = threadIdx.x; i < tn; i += blockDim.x) {
      cand_out[at + i] = cand_t[i];
      lcp_out[at + i] = lcp_t[i];
    }
  }
}

}  // namespace

// rows uint8 [n, w] (row i's lens[i] bytes, zero past them), lens int64
// [n] -> lcp, cand int64 [n, w]: the v1 match table. One launch.
extern "C" int ct_lz_match_v1(const void* rows, const void* lens, void* lcp, void* cand, int n,
                              int w, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (n < 1 || w < 1 || w > (1 << 30)) return (int)cudaErrorInvalidValue;
  const int tile = min(TILE, w);
  int sort_n = 1, bits = 0;
  while (sort_n < tile) {
    sort_n <<= 1;
    ++bits;
  }
  const int hash_bits = bits + 1;  // at most half full
  // the sort's keys: ITEMS a thread, a power of two of threads, a warp at least
  sort_n = max(sort_n, 32 * ITEMS);
  const int threads = sort_n / ITEMS;
  // the window, 16 bytes of slack for the last compare's second word
  const int win = (int)((min((long long)w, (long long)MAX_DISTANCE + tile + LCP_CAP) + 15) & ~15LL) +
                  16;
  // the window, the slots (8 bytes) and their last positions (4), the sort
  // keys, cand and lcp: 221,200 bytes at a full tile
  const int smem = win + 12 * (2 * sort_n) + 4 * sort_n + 8 * tile;
  cudaError_t e =
      cudaFuncSetAttribute(match_v1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (w + tile - 1) / tile;
  const long long tasks = (long long)n * tiles;
  match_v1_kernel<<<(unsigned)min(tasks, 1LL << 20), threads, smem, st>>>(
      (const uint8_t*)rows, (const long long*)lens, (long long*)lcp, (long long*)cand, w, tile,
      tiles, tasks, sort_n, hash_bits, win);
  return (int)cudaGetLastError();
}
