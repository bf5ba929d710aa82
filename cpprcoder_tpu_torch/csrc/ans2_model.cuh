// CT-ANS2's model on the card, for kernels W (ans2_encode.cu) and Y
// (ans2_decode.cu): the window schedule, the bulk copies on mbarriers both
// stage with, and the model's two window-start steps as warp functions,
// the rescale and the exact normalize of 256 counts to a table summing to
// 2^14. A warp holds the 256 counts as 8 a lane, symbols 8l..8l+7 in lane
// l, so neither step waits on a CTA barrier.
//
// The rescale (warp_rescale): counts = (c >> 1) | 1, and the new total
// without a sum of the counts: sum((c >> 1) | 1) = (total - #odd(c)) / 2 +
// #even(c >> 1), the two counts by one warp reduction.
//
// The normalize (warp_normalize) is models/static_table.normalize_freqs
// bit for bit (the JAX package's twin is
// cpprcoder_tpu/models/table_jax.py:51-102):
//   1. pre-scale: shift = max(0, bitlen(n - 1) - 14), n the counts' sum
//      (64-bit); c = count >> shift, and a present count that became 0 is 1.
//      Then c <= 2^14, so c << 14 fits a u32;
//   2. floor scale: f = c * 2^14 / n', r = c * 2^14 % n', n' = sum of c;
//   3. a present symbol with f = 0 gets f = 1;
//   4. d = 2^14 - sum of f. The order the spec ranks symbols in is that of
//      packed unique keys, descending: d > 0, key = (r + 1) << 8 | (255 -
//      s) for a present symbol and 255 - s for an absent one (last); d < 0,
//      key = f << 8 | (255 - s) (the richest first; ties to the lower
//      symbol, as the packed index makes every key unique). The warp sorts
//      its 256 keys (bitonic: the stages within a lane's 8 in registers, the
//      others by __shfl_xor_sync). d > 0: +1 to every present symbol whose
//      key is at least the d-th largest, T (the d largest are present: d
//      is below the count of present symbols). d < 0: in sorted order each
//      symbol gives clip(need - (excess before it), 0, f - 1), the excess
//      before it an exclusive scan; the symbols above the one where the
//      scan reaches need give all their excess (f becomes 1), that one
//      gives the rest, the others nothing. So only the boundary's key and
//      take are broadcast, and each lane settles its own symbols;
//   5. if one symbol holds all of 2^14 (exactly when one symbol is
//      present), it gives 1 to symbol (s + 1) % 256.
// CT-ANS2's counts never fall below 1 (they start at 1, and a rescale
// leaves (c >> 1) | 1), so every symbol is present and rule 5 cannot fire
// on the codec's path; the normalize is written whole all the same, and
// `ct_ans2_normalize` runs it alone on any count vector for the tests.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ans2 {

constexpr uint32_t PROB_BITS = 14;
constexpr uint32_t TOTAL = 1u << PROB_BITS;
constexpr uint32_t LOW = 1u << 16;
constexpr uint32_t FULL_MASK = 0xFFFFFFFFu;
constexpr int MAX_WARPS = 32;
constexpr int PER_LANE = 8;  // counts a lane: symbols 8l..8l+7

// Window w's first step at refresh_log2 r (r <= 31): 0, then 1, 2, 4, ...,
// 2^(r-1), then multiples of 2^r.
__host__ __device__ __forceinline__ unsigned long long window_start(unsigned long long w, int r) {
  if (w == 0) return 0;
  return w <= (unsigned long long)r ? 1ull << (w - 1) : (w - r) << r;
}

// The table (window) that codes step t: reference/ans2_ref.snapshot_index.
__device__ __forceinline__ uint32_t snapshot_index(uint32_t t, int r) {
  if (t < (1u << r)) return t == 0 ? 0u : 32u - __clz(t);
  return (uint32_t)r + (t >> r);
}

// Positions of the steps [a, b) that code a symbol: [a*K, b*K) cut at n.
__host__ __device__ __forceinline__ unsigned long long coded(unsigned long long a,
                                                             unsigned long long b,
                                                             unsigned long long n, int K) {
  const unsigned long long lo = a * K < n ? a * K : n, hi = b * K < n ? b * K : n;
  return hi - lo;
}

// ------------------------------------------------------------ bulk copies

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One thread: bytes (a multiple of 16, both addresses 16-byte aligned)
// from global memory to shared memory, completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ------------------------------------------------------- warp reductions

__device__ __forceinline__ unsigned long long warp_sum64(unsigned long long v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// The warp's exclusive prefix sum of v in lane order.
__device__ __forceinline__ uint32_t warp_exclusive_scan(uint32_t v) {
  const int lane = threadIdx.x & 31;
  uint32_t incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane >= o) incl += y;
  }
  return incl - v;
}

// ------------------------------------------------------------ the rescale

// Warp: counts (c >> 1) | 1 and their total, from the old exact total.
__device__ __forceinline__ void warp_rescale(unsigned long long (&cnt)[PER_LANE],
                                             unsigned long long& total) {
  uint32_t odd = 0, even_half = 0;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const unsigned long long h = cnt[i] >> 1;
    odd += (uint32_t)(cnt[i] & 1);
    even_half += (uint32_t)(~h & 1);
    cnt[i] = h | 1;
  }
  const uint32_t both = __reduce_add_sync(FULL_MASK, odd | even_half << 16);
  total = (total - (both & 0xFFFFu)) / 2 + (both >> 16);
}

// ---------------------------------------------------------- the normalize

// Element e of the warp's 256 (lane e / 8, register e % 8) after a bitonic
// sort, descending. The stages of distance 1, 2, 4 swap within a lane's
// registers, the others across lanes (distance j / 8) by shuffles.
__device__ __forceinline__ void warp_sort_desc(uint32_t (&v)[PER_LANE]) {
  const uint32_t lane = threadIdx.x & 31;
#pragma unroll
  for (uint32_t k = 2; k <= 256; k <<= 1) {
#pragma unroll
    for (uint32_t j = k >> 1; j > 0; j >>= 1) {
      if (j >= PER_LANE) {
        const uint32_t lj = j / PER_LANE;
        const bool lower = (lane & lj) == 0;
#pragma unroll
        for (int i = 0; i < PER_LANE; ++i) {
          const uint32_t e = lane * PER_LANE + i;
          const bool up = (e & k) == 0;
          const uint32_t o = __shfl_xor_sync(FULL_MASK, v[i], lj);
          v[i] = (lower == up) ? max(v[i], o) : min(v[i], o);
        }
      } else {
#pragma unroll
        for (int i = 0; i < PER_LANE; ++i) {
          if (i & j) continue;
          const uint32_t e = lane * PER_LANE + i;
          const bool up = (e & k) == 0;
          const uint32_t a = v[i], b = v[i + j];
          v[i] = up ? max(a, b) : min(a, b);
          v[i + j] = up ? min(a, b) : max(a, b);
        }
      }
    }
  }
}

// Register i of v, i a run-time index, without a local array.
__device__ __forceinline__ uint32_t pick(const uint32_t (&v)[PER_LANE], uint32_t i) {
  uint32_t x = v[0];
#pragma unroll
  for (int q = 1; q < PER_LANE; ++q) x = i == (uint32_t)q ? v[q] : x;
  return x;
}

// Warp: normalize_freqs(counts, 14), counts of symbols 8l..8l+7 in lane l.
// -> f and their exclusive cumulative frequencies c, in the same places.
__device__ __forceinline__ void warp_normalize(const unsigned long long (&cnt)[PER_LANE],
                                               uint32_t (&f)[PER_LANE],
                                               uint32_t (&c)[PER_LANE]) {
  const uint32_t lane = threadIdx.x & 31;
  unsigned long long part = 0;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) part += cnt[i];
  const unsigned long long n = warp_sum64(part);
  if (n == 0) {  // no symbol: the all-zero table
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) f[i] = c[i] = 0;
    return;
  }
  const int bitlen = 64 - __clzll((long long)(n - 1));
  const int shift = bitlen > (int)PROB_BITS ? bitlen - (int)PROB_BITS : 0;
  uint32_t present = 0, csum = 0;  // present: bit i for symbol 8l + i
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    uint32_t v = (uint32_t)(cnt[i] >> shift);
    if (cnt[i] > 0) {
      present |= 1u << i;
      v = v ? v : 1u;
    }
    c[i] = v;  // the pre-scaled count, for now
    csum += v;
  }
  const uint32_t np = __reduce_add_sync(FULL_MASK, csum);
  uint32_t r[PER_LANE], fsum = 0;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const uint32_t scaled = c[i] << PROB_BITS;
    f[i] = scaled / np;
    r[i] = scaled - f[i] * np;
    if (((present >> i) & 1u) && f[i] == 0) f[i] = 1;
    fsum += f[i];
  }
  const int d = (int)TOTAL - (int)__reduce_add_sync(FULL_MASK, fsum);
  if (d != 0) {
    uint32_t key[PER_LANE], sorted[PER_LANE];
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const uint32_t s = lane * PER_LANE + i;
      const uint32_t hi = d > 0 ? (((present >> i) & 1u) ? r[i] + 1 : 0u) : f[i];
      key[i] = sorted[i] = hi << 8 | (255u - s);
    }
    warp_sort_desc(sorted);
    if (d > 0) {
      // the d-th largest key, at sorted place d - 1
      const uint32_t at = (uint32_t)d - 1;
      const uint32_t t = __shfl_sync(FULL_MASK, pick(sorted, at % PER_LANE), at / PER_LANE);
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) f[i] += ((present >> i) & 1u) && key[i] >= t;
    } else {
      // the excess (f - 1) before each sorted place, and the place where it
      // reaches need: its key and what it gives
      const uint32_t need = (uint32_t)(-d);
      uint32_t ex[PER_LANE], lsum = 0;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        const uint32_t fs = sorted[i] >> 8;
        ex[i] = fs ? fs - 1 : 0u;
        lsum += ex[i];
      }
      uint32_t before = warp_exclusive_scan(lsum), at_key = 0, at_take = 0;
      bool here = false;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        const bool b = before < need && before + ex[i] >= need;
        at_key = b ? sorted[i] : at_key;
        at_take = b ? need - before : at_take;
        here |= b;
        before += ex[i];
      }
      const int src = __ffs(__ballot_sync(FULL_MASK, here)) - 1;
      const uint32_t bk = __shfl_sync(FULL_MASK, at_key, src);
      const uint32_t bt = __shfl_sync(FULL_MASK, at_take, src);
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        if (key[i] > bk)
          f[i] = f[i] ? 1u : 0u;
        else if (key[i] == bk)
          f[i] -= bt;
      }
    }
  }
  // rule 5: one present symbol holds all of 2^14
  if (__reduce_add_sync(FULL_MASK, (uint32_t)__popc(present)) == 1) {
    const uint32_t own = present ? lane * PER_LANE + (uint32_t)(__ffs(present) - 1) : 0u;
    const uint32_t s = __reduce_add_sync(FULL_MASK, own);
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const uint32_t t = lane * PER_LANE + i;
      f[i] += (t == ((s + 1) & 255u)) ? 1u : 0u;
      f[i] -= (t == s) ? 1u : 0u;
    }
  }
  uint32_t run = 0;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) run += f[i];
  run = warp_exclusive_scan(run);
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    c[i] = run;
    run += f[i];
  }
}

}  // namespace ans2
