// CT-RC3's shared model and coder steps, for kernels U (o1_encode.cu) and V
// (o1_decode.cu). What they compute is in those files and in
// ops/o1_ops.py's docstring; this header holds the model's layout, its
// set-up (and its copy to and from global memory between U's chunks), the
// rescale and the update that both kernels run the same way, the sums by
// trees both use, and U's lookup (V finds its symbol by counts of
// compares: o1_decode.cu).
//
// The model, one copy a stream (one CTA), its counts and totals of type C:
// u32, or u64 where one of them can reach 2^32 - 1 (a limit_log2 of 32 or
// more over a long stream: o1_ops.counts_long, fault P7):
//   t1      order-1 counts [256][256]: u16 pairs in shared memory (128 KiB,
//           count e of row r in half e & 1 of word r*128 + e/2) where every
//           count stays below 2^16 (WIDE false), else C in global memory
//           (256 or 512 KiB of scratch, L2-resident, read with ld.global.cg
//           so that no stale L1 line is read after another thread's atomic);
//   bsum1   per row the 16 sums of counts 16b..16b+15, C [256][16];
//   rowtot  the row totals, C [256];
//   t0      order-0 counts, C [256], with bsum0 [16] and tot0 (V), or
//           tot0 and c0 [256], t0's exclusive prefix sums, scanned anew
//           every step (U: T0SCAN).
// Every count starts at 1 (row totals 256, block sums 16). The coding reads
// the counts and sums as u32 (truncated where C is u64) beside the row's
// total and tot0 in 64 bits: wherever that tot_eff fits u32 (t >= 1 needs
// it), every count and prefix it sums is below it, so the u32 sums are
// exact; where it does not, the step is reported and nothing after it
// counts. Before the first such step no total reaches 2^32 + 2^24 (a row
// grows only where it is read, by at most K*inc a step), so u64 holds
// every count exactly, and a total that reaches 2^limit_log2 is halved
// at the oracle's step at every limit_log2.
//
// A step, between barriers:
//   rescale  warp w takes rows w, w + warps, ...; a row whose total has
//            reached limit1 is halved, (f >> 1) | 1, by the warp (8 counts
//            a lane), which rebuilds its block sums (lanes 2b, 2b+1: block
//            b) and total; the last warp does t0 the same way once tot0 has
//            reached limit0. Every row is checked every step: a halved row
//            can still be at its limit.
//   code     U: each lane reads its symbol's blended f and exclusive prefix
//            in its context's row (the blended block sums before its block,
//            then the counts before it in the block: 16-byte loads, summed
//            by trees 4 levels deep). V searches by counts of compares.
//   update   each active lane adds inc to t1[ctx][s] (a u16 half through an
//            atomic add on its word: no carry, the count stays below 2^16),
//            the block sums, rowtot[ctx], t0[s] and bsum0; each warp adds
//            inc times its active lanes to tot0 (T0SCAN: t0[s] alone, whose
//            sums the next rescale scans). Grouped, a warp's lanes with
//            one address add once (__match_any_sync): U and V past 1,024
//            lanes (below, groups formed a step ahead were slower at every
//            shape timed: PERF.md, section 6).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace o1 {

constexpr uint32_t RC_TOP = 1u << 24;
constexpr uint32_t EV_RUN_MASK = (1u << 22) - 1;
constexpr uint32_t FULL = 0xFFFFFFFFu;
constexpr int SLOTS = 3;           // shift_low slots a step (o1_ops.N_SLOTS)
constexpr int MAX_THREADS = 1024;  // lanes a CTA codes one a thread
constexpr int MIN_THREADS = 256;   // a CTA has at least 8 warps for the rescale

// dynamic shared memory: bsum1, rowtot, t0, bsum0, tot0 (padded to 16 B),
// c0, then t1 when it is kept there
constexpr int BSUM1_WORDS = 256 * 16;
constexpr int MODEL_WORDS = BSUM1_WORDS + 256 + 256 + 16 + 4 + 256;  // counts of type C
constexpr int T1_NARROW_WORDS = 256 * 128;
template <class C>
constexpr int smem_bytes(bool wide) {
  return (int)sizeof(C) * MODEL_WORDS + (wide ? 0 : 4 * T1_NARROW_WORDS);
}

// The counts and totals where one can reach 2^32 - 1
using u64 = unsigned long long;

template <class C>
struct Model {
  uint32_t* t1;  // u16 pairs, or where WIDE C counts (t1w)
  C* bsum1;
  C* rowtot;
  C* t0;
  C* bsum0;
  C* tot0;
  C* c0;
};

template <class C>
__device__ __forceinline__ C* t1w(const Model<C>& m) { return reinterpret_cast<C*>(m.t1); }

template <class C>
__device__ __forceinline__ Model<C> carve(uint32_t* smem, uint32_t* t1_global, bool wide) {
  Model<C> m;
  m.bsum1 = reinterpret_cast<C*>(smem);
  m.rowtot = m.bsum1 + BSUM1_WORDS;
  m.t0 = m.rowtot + 256;
  m.bsum0 = m.t0 + 256;
  m.tot0 = m.bsum0 + 16;
  m.c0 = m.tot0 + 4;
  m.t1 = wide ? t1_global : reinterpret_cast<uint32_t*>(m.bsum1 + MODEL_WORDS);
  return m;
}

// Every count 1; barrier after.
template <bool WIDE, class C>
__device__ void init_model(const Model<C>& m) {
  const int tid = threadIdx.x, bd = blockDim.x;
  for (int i = tid; i < BSUM1_WORDS; i += bd) m.bsum1[i] = 16;
  for (int i = tid; i < 256; i += bd) m.rowtot[i] = 256, m.t0[i] = 1, m.c0[i] = i;
  if (tid < 16) m.bsum0[tid] = 16;
  if (tid == 0) *m.tot0 = 256;
  if (WIDE) {
    for (int i = tid; i < 256 * 256; i += bd) __stcg(t1w(m) + i, (C)1);
  } else {
    for (int i = tid; i < T1_NARROW_WORDS; i += bd) m.t1[i] = 0x00010001u;
  }
  __syncthreads();
}

// The model in shared memory (t1 too where it is kept there), copied to
// or from global memory between kernel U's chunks: smem_bytes<C>(WIDE) / 4
// words; barrier after.
template <bool WIDE, class C>
__device__ void copy_model(uint4* dst, const uint4* src) {
  constexpr int n = ((int)sizeof(C) / 4 * MODEL_WORDS + (WIDE ? 0 : T1_NARROW_WORDS)) / 4;
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
}

template <class C>
__device__ __forceinline__ C halve(C f) { return (f >> 1) | (C)1; }
__device__ __forceinline__ uint32_t halve2(uint32_t w) { return ((w >> 1) & 0x7FFF7FFFu) | 0x00010001u; }
__device__ __forceinline__ uint32_t sum2(uint32_t w) { return (w & 0xFFFFu) + (w >> 16); }

__device__ __forceinline__ uint32_t warp_sum(uint32_t s) { return __reduce_add_sync(FULL, s); }
__device__ __forceinline__ u64 warp_sum(u64 s) {
#pragma unroll
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  return s;
}

// Four consecutive values of a C array (16-byte aligned) as u32: cached
// (shared memory) or read with ld.global.cg (CG, t1 in global memory).
template <bool CG = false>
__device__ __forceinline__ uint4 load4(const uint32_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  return CG ? __ldcg(q) : *q;
}
template <bool CG = false>
__device__ __forceinline__ uint4 load4(const u64* p) {
  const ulonglong2* q = reinterpret_cast<const ulonglong2*>(p);
  const ulonglong2 a = CG ? __ldcg(q) : q[0], b = CG ? __ldcg(q + 1) : q[1];
  return make_uint4((uint32_t)a.x, (uint32_t)a.y, (uint32_t)b.x, (uint32_t)b.y);
}

// Warp: the 8 halved counts of a lane sum to s; the block sums (lanes 2b,
// 2b+1) and the total follow.
template <class C>
__device__ __forceinline__ void publish_sums(C s, C* bsum, C* total) {
  const int ln = threadIdx.x & 31;
  const C b = s + __shfl_xor_sync(FULL, s, 1);
  if (!(ln & 1)) bsum[ln >> 1] = b;
  const C t = warp_sum(s);
  if (ln == 0) *total = t;
}

// Warp: 8 counts of type C at p (a lane's), halved in place (CG: in
// global memory) -> their sum.
template <bool CG>
__device__ __forceinline__ uint32_t halve8(uint32_t* p) {
  uint4* q = reinterpret_cast<uint4*>(p);
  uint4 a = CG ? __ldcg(q) : q[0], b = CG ? __ldcg(q + 1) : q[1];
  a = make_uint4(halve(a.x), halve(a.y), halve(a.z), halve(a.w));
  b = make_uint4(halve(b.x), halve(b.y), halve(b.z), halve(b.w));
  if (CG) {
    __stcg(q, a);
    __stcg(q + 1, b);
  } else {
    q[0] = a;
    q[1] = b;
  }
  return a.x + a.y + a.z + a.w + b.x + b.y + b.z + b.w;
}
template <bool CG>
__device__ __forceinline__ u64 halve8(u64* p) {
  ulonglong2* q = reinterpret_cast<ulonglong2*>(p);
  u64 s = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ulonglong2 a = CG ? __ldcg(q + k) : q[k];
    a.x = halve(a.x), a.y = halve(a.y);
    if (CG)
      __stcg(q + k, a);
    else
      q[k] = a;
    s += a.x + a.y;
  }
  return s;
}

// Warp: row r of t1 halved (counts 8l..8l+7 a lane).
template <bool WIDE, class C>
__device__ __forceinline__ void halve_row(const Model<C>& m, int r) {
  const int ln = threadIdx.x & 31;
  C s;
  if (WIDE) {
    s = halve8<true>(t1w(m) + r * 256 + 8 * ln);
  } else {
    uint4* p = reinterpret_cast<uint4*>(m.t1 + r * 128) + ln;
    uint4 a = *p;
    a = make_uint4(halve2(a.x), halve2(a.y), halve2(a.z), halve2(a.w));
    *p = a;
    s = sum2(a.x) + sum2(a.y) + sum2(a.z) + sum2(a.w);
  }
  publish_sums(s, m.bsum1 + r * 16, m.rowtot + r);
}

// Warp: t0 halved.
template <class C>
__device__ __forceinline__ void halve_t0(const Model<C>& m) {
  publish_sums(halve8<false>(m.t0 + 8 * (threadIdx.x & 31)), m.bsum0, m.tot0);
}

// Warp, T0SCAN: t0's total into tot0, t0 halved first where it has
// reached limit0, and its exclusive prefix sums into c0 (counts 8l..8l+7
// a lane).
__device__ __forceinline__ void scan_t0(const Model<uint32_t>& m, uint32_t limit0) {
  const int ln = threadIdx.x & 31;
  uint4* p = reinterpret_cast<uint4*>(m.t0) + 2 * ln;
  uint4 a = p[0], b = p[1];
  uint32_t s = a.x + a.y + a.z + a.w + b.x + b.y + b.z + b.w;
  uint32_t tot = __reduce_add_sync(FULL, s);
  if (tot >= limit0) {
    a = make_uint4(halve(a.x), halve(a.y), halve(a.z), halve(a.w));
    b = make_uint4(halve(b.x), halve(b.y), halve(b.z), halve(b.w));
    p[0] = a;
    p[1] = b;
    s = a.x + a.y + a.z + a.w + b.x + b.y + b.z + b.w;
    tot = __reduce_add_sync(FULL, s);
  }
  uint32_t incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(FULL, incl, o);
    if (ln >= o) incl += y;
  }
  uint32_t c = incl - s;
  uint4 ca, cb;
  ca.x = c, c += a.x, ca.y = c, c += a.y, ca.z = c, c += a.z, ca.w = c, c += a.w;
  cb.x = c, c += b.x, cb.y = c, c += b.y, cb.z = c, c += b.z, cb.w = c;
  uint4* q = reinterpret_cast<uint4*>(m.c0) + 2 * ln;
  q[0] = ca;
  q[1] = cb;
  if (ln == 0) *m.tot0 = tot;
}
__device__ __forceinline__ void scan_t0(const Model<u64>& m, u64 limit0) {
  const int ln = threadIdx.x & 31;
  u64* p = m.t0 + 8 * ln;
  u64 s = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) s += p[k];
  u64 tot = warp_sum(s);
  if (tot >= limit0) {
    s = halve8<false>(p);
    tot = warp_sum(s);
  }
  u64 incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const u64 y = __shfl_up_sync(FULL, incl, o);
    if (ln >= o) incl += y;
  }
  u64 c = incl - s;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const u64 f = p[k];
    m.c0[8 * ln + k] = c;
    c += f;
  }
  if (ln == 0) *m.tot0 = tot;
}

// The rescale phase (every warp; blockDim.x a power of two, 256..1024):
// warp w checks rows w, w + nw, ... and halves those at or over limit1;
// the last warp does t0 (T0SCAN: scan_t0); a barrier after. Strided, rows that cross
// together (a text's letters) fall to different warps: faster at K = 256
// than a run of 256 / nw rows a warp or a spread whose reads fall in
// distinct banks, and within 5% of both at the other shapes timed
// (PERF.md, section 6).
template <bool WIDE, bool T0SCAN = false, class C>
__device__ void rescale(const Model<C>& m, C limit1, C limit0) {
  const int ln = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  uint32_t over = __ballot_sync(FULL, ln < 256 / nw && m.rowtot[w + nw * ln] >= limit1);
  while (over) {
    const int i = __ffs(over) - 1;
    over &= over - 1;
    halve_row<WIDE>(m, w + nw * i);
  }
  if (T0SCAN) {
    if (w == nw - 1) scan_t0(m, limit0);
  } else if (w == nw - 1 && *m.tot0 >= limit0) {
    halve_t0(m);
  }
  __syncthreads();
}

__device__ __forceinline__ uint32_t u4_at(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Inclusive prefix sums of 16 values in registers, 4 levels deep, and
// pairwise trees over 16 values (4 levels, not a chain of 15). Each level
// is its own instantiation, so that every index is a constant and the
// arrays stay in registers.
template <int D>
__device__ __forceinline__ void scan_level(uint32_t (&p)[16]) {
#pragma unroll
  for (int k = 15; k >= D; --k) p[k] += p[k - D];
}
__device__ __forceinline__ void scan16(uint32_t (&p)[16]) {
  scan_level<1>(p);
  scan_level<2>(p);
  scan_level<4>(p);
  scan_level<8>(p);
}

struct Add {
  __device__ __forceinline__ uint32_t operator()(uint32_t a, uint32_t b) const { return a + b; }
};
struct Max {
  __device__ __forceinline__ uint32_t operator()(uint32_t a, uint32_t b) const { return max(a, b); }
};
struct Min {
  __device__ __forceinline__ uint32_t operator()(uint32_t a, uint32_t b) const { return min(a, b); }
};

template <int H, class Op>
__device__ __forceinline__ void tree_level(uint32_t (&x)[16], Op op) {
#pragma unroll
  for (int k = 0; k < H; ++k) x[k] = op(x[k], x[k + H]);
}
template <class Op>
__device__ __forceinline__ uint32_t tree(uint32_t (&x)[16], Op op) {
  tree_level<8>(x, op);
  tree_level<4>(x, op);
  tree_level<2>(x, op);
  tree_level<1>(x, op);
  return x[0];
}

// The 16 counts of block b of row r of t1 (as u32).
template <bool WIDE, class C>
__device__ __forceinline__ void t1_block(const Model<C>& m, int r, int b, uint32_t (&e)[16]) {
  if (WIDE) {
    const C* p = t1w(m) + r * 256 + b * 16;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = load4<true>(p + 4 * q);
      e[4 * q] = v.x, e[4 * q + 1] = v.y, e[4 * q + 2] = v.z, e[4 * q + 3] = v.w;
    }
  } else {
    const uint4* p = reinterpret_cast<const uint4*>(m.t1 + r * 128 + b * 8);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint4 v = p[q];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t w = u4_at(v, i);
        e[8 * q + 2 * i] = w & 0xFFFFu;
        e[8 * q + 2 * i + 1] = w >> 16;
      }
    }
  }
}

template <class C>
__device__ __forceinline__ void t0_block(const Model<C>& m, int b, uint32_t (&e)[16]) {
  const C* p = m.t0 + b * 16;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v = load4(p + 4 * q);
    e[4 * q] = v.x, e[4 * q + 1] = v.y, e[4 * q + 2] = v.z, e[4 * q + 3] = v.w;
  }
}

// The encoder's read: (c, f, tot) of symbol s in context r, blended. The
// block sums before s's block and the counts before it in the block are
// summed by two trees (blended, with t0's, unless T0SCAN: then t0's prefix
// is c0[s]); f is read directly. tot is also formed in 64 bits, beside
// the rest: past 2^32 - 1 (t = 0 whatever the range) the triple is the mark
// (0, 0, 2^32 - 1), which the coder reports (f = 0); c and f fit u32
// wherever tot does (and are summed as u32: the model's docstring).
template <bool WIDE, bool T0SCAN = false, class C>
__device__ __forceinline__ void lookup(const Model<C>& m, uint32_t r, uint32_t s, int blend,
                                       C tot0, uint32_t& c, uint32_t& f, uint32_t& tot) {
  const int b = s >> 4, i = s & 15;
  const uint32_t f1 = WIDE ? (uint32_t)__ldcg(t1w(m) + r * 256 + s)
                           : (m.t1[r * 128 + (s >> 1)] >> (16 * (s & 1))) & 0xFFFFu;
  const C rt = m.rowtot[r];
  f = (f1 << blend) + (uint32_t)m.t0[s];
  tot = ((uint32_t)rt << blend) + (uint32_t)tot0;
  uint32_t p[16], e1[16], e0[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v1 = load4(m.bsum1 + r * 16 + 4 * q);
    const uint4 v0 = T0SCAN ? make_uint4(0u, 0u, 0u, 0u) : load4(m.bsum0 + 4 * q);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      p[4 * q + k] = 4 * q + k < b ? (u4_at(v1, k) << blend) + u4_at(v0, k) : 0u;
  }
  t1_block<WIDE>(m, r, b, e1);
  if (T0SCAN) {
#pragma unroll
    for (int k = 0; k < 16; ++k) e0[k] = 0u;
  } else {
    t0_block(m, b, e0);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) e1[k] = k < i ? (e1[k] << blend) + e0[k] : 0u;
  c = tree(p, Add()) + tree(e1, Add()) + (T0SCAN ? (uint32_t)m.c0[s] : 0u);
  if (((u64)rt << blend) + tot0 > FULL) c = 0u, f = 0u, tot = FULL;
}

// The update phase, a warp at a time (every lane of the warp calls it):
// each active lane adds inc to t1[r][s], its block sum, rowtot[r], t0[s]
// and its block sum (atomics: the sums do not depend on the order), and
// lane 0 adds inc times the warp's active lanes to tot0 (T0SCAN: t0[s]
// alone). GROUPED: lanes with the same (r, s) (the same s) add once, inc
// times the group's size.
template <bool WIDE, bool GROUPED, bool T0SCAN = false, class C>
__device__ __forceinline__ void update_step(const Model<C>& m, bool active, uint32_t r, uint32_t s,
                                            uint32_t inc) {
  const int ln = threadIdx.x & 31;
  bool lead1 = active, lead0 = active;
  uint32_t add1 = inc, add0 = inc;
  if (GROUPED) {
    // inactive lanes get keys of their own, outside both ranges
    const uint32_t g1 = __match_any_sync(FULL, active ? r << 8 | s : 0x10000u + (uint32_t)ln);
    const uint32_t g0 = __match_any_sync(FULL, active ? s : 0x100u + (uint32_t)ln);
    lead1 = active && __ffs(g1) - 1 == ln, lead0 = active && __ffs(g0) - 1 == ln;
    add1 = inc * __popc(g1), add0 = inc * __popc(g0);
  }
  if (lead1) {
    if (WIDE)
      atomicAdd(t1w(m) + r * 256 + s, (C)add1);
    else
      atomicAdd(m.t1 + r * 128 + (s >> 1), add1 << (16 * (s & 1)));
    atomicAdd(m.bsum1 + r * 16 + (s >> 4), (C)add1);
    atomicAdd(m.rowtot + r, (C)add1);
  }
  if (lead0) {
    atomicAdd(m.t0 + s, (C)add0);
    if (!T0SCAN) atomicAdd(m.bsum0 + (s >> 4), (C)add0);
  }
  if (!T0SCAN) {
    const uint32_t a = __popc(__ballot_sync(FULL, active));
    if (ln == 0 && a) atomicAdd(m.tot0, (C)(inc * a));
  }
}

// ------------------------------------------------------- the coder's steps
// (kernel J's, csrc/rc_exact.cu, copied so that J and L stay as they are)

// One shift_low, as selects: -> its packed event, 0 when it emits nothing.
__device__ __forceinline__ uint32_t shift_low(uint32_t& low, uint32_t& carry, uint32_t& cache,
                                              uint32_t& csize) {
  const bool out = low < 0xFF000000u || carry != 0;
  const uint32_t ev = 0x80000000u | (((cache + carry) & 0xFFu) << 23) | ((carry & 1u) << 22) |
                      ((csize - 1u) & EV_RUN_MASK);
  cache = out ? low >> 24 : cache;
  csize = out ? 1u : csize + 1u;
  carry = out ? 0u : carry;
  low <<= 8;
  return out ? ev : 0u;
}

// Up to SLOTS shift_lows while range < 2^24; e[] gets the events.
__device__ __forceinline__ void renorm_encode(uint32_t& low, uint32_t& carry, uint32_t& rng,
                                              uint32_t& cache, uint32_t& csize,
                                              uint32_t (&e)[SLOTS]) {
#pragma unroll
  for (int sl = 0; sl < SLOTS; ++sl) {
    const bool d = rng < RC_TOP;
    uint32_t l2 = low, c2 = carry, a2 = cache, s2 = csize;
    const uint32_t ev = shift_low(l2, c2, a2, s2);
    e[sl] = d ? ev : 0u;
    low = d ? l2 : low;
    carry = d ? c2 : carry;
    cache = d ? a2 : cache;
    csize = d ? s2 : csize;
    rng = d ? rng << 8 : rng;
  }
}

// The decoder's side: up to SLOTS bytes from the queue q (occ bytes, the
// oldest highest) into code while range < 2^24.
__device__ __forceinline__ void renorm_decode(uint32_t& code, uint32_t& rng, uint32_t& occ,
                                              uint64_t q) {
#pragma unroll
  for (int sl = 0; sl < SLOTS; ++sl) {
    const bool d = rng < RC_TOP;
    const uint32_t o = d ? occ - 1 : occ;
    const uint32_t byte = (uint32_t)(q >> (8 * o)) & 0xFFu;
    code = d ? (code << 8) | byte : code;
    rng = d ? rng << 8 : rng;
    occ = o;
  }
}

// Steps whose t = range / tot_eff is 0 (the coder would not end): a
// thread keeps the least (step << 32 | lane) of its lanes' such steps in a
// register (NONE: none), off the steps' chain, and at its end adds it to
// *flag (all ones before the call) by atomicMin; the wrapper reads the
// flag once after the call.
constexpr unsigned long long NONE = ~0ull;
__device__ __forceinline__ unsigned long long first_bad(unsigned long long first, bool bad, int j,
                                                        int lane) {
  const unsigned long long at = (unsigned long long)j << 32 | (uint32_t)lane;
  return bad && at < first ? at : first;
}
__device__ __forceinline__ void report_steps(unsigned long long* flag, unsigned long long first) {
  if (first != NONE) atomicMin(flag, first);
}

// The limit a total of type C is held to: 2^log2, or past C's width none,
// all ones (u32 only where no total reaches 2^32 - 1, u64 where none
// reaches 2^64 - 1: o1_ops.counts_long).
template <class C>
__host__ __device__ inline C limit_of(int log2) {
  return log2 >= 8 * (int)sizeof(C) ? ~(C)0 : (C)1 << log2;
}

// The model's form, an argument of the entry points: FORM_WIDE keeps t1
// in global memory (o1_ops.table_wide), FORM_LONG the counts and totals
// as u64 (o1_ops.counts_long).
constexpr int FORM_WIDE = 1, FORM_LONG = 2;

// Header values the kernels take: a u8 each, and blend_log2 <= 23 (from 24
// on step 0 has t = 0: o1_ops.check_params refuses it).
__host__ __device__ inline bool bad_header(int inc, int limit1_log2, int limit0_log2,
                                           int blend_log2) {
  return inc < 0 || inc > 255 || limit1_log2 < 0 || limit1_log2 > 255 || limit0_log2 < 0 ||
         limit0_log2 > 255 || blend_log2 < 0 || blend_log2 > 23;
}

// The CTA's threads for K lanes: K rounded up to 256, at most 1,024.
__host__ __device__ inline int cta_threads(int K) {
  return K <= MIN_THREADS ? MIN_THREADS : K >= MAX_THREADS ? MAX_THREADS : K;
}

}  // namespace o1
