// Kernel V: CT-RC3 (the order-1 blended adaptive range coder) decode on
// Hopper.
//
// It replaces no Pallas kernel: the JAX package runs this decoder as one
// compiled lax.scan (cpprcoder_tpu/ops/o1_ops.py:169 `_decode_fn`, scan
// :209), its bytes fed by range_ops.py:248 `_queue_refill` and :264
// `_queue_read`.
//
// What it computes, per stream of n bytes over K chunked lanes (kernel U's
// layout): each lane reads its big-endian word row (words [l4, K],
// word-major) through a byte queue that takes a whole word whenever fewer
// than 3 bytes are buffered (zero past the row's end). With the shared model
// of o1_model.cuh rescaled before the step, an active lane with context ctx
// (its previous symbol, 0 at j = 0) takes tot = A*rowtot[ctx] + tot0 (in 64
// bits: a step whose t is 0, tot above the range, goes to a flag, the
// first (step, lane), and the wrapper raises), t = range / tot,
// v = min(code / t, tot - 1), and the symbol s whose
// blended inclusive prefix is the first above v; code -= t*c; range =
// (c + f == tot) ? range - t*c : t*f; up to 3 bytes from the queue while
// range < 2^24. s goes to out[i*L + j]; then every active lane adds inc to
// the model, as the encoder does.
//
// Design (second round; the first was kernel U's three phases with a
// chain search). All lanes share the model, so a stream runs in one CTA, a
// thread a lane up to 1,024 lanes; a step is three phases between barriers:
// o1_model.cuh's rescale, the coding and o1_model.cuh's update. What changed
// (timed against the first design in PERF.md, section 6):
//   - each lane's next word is loaded a refill ahead into a register, and
//     its row length is read once: no global read waits on a lane's chain;
//   - the search counts compares rather than walking a chain: the row's 16
//     blended block sums are loaded and scanned while the divides run; the
//     block is the number of its prefixes at or below v, then likewise the
//     count in the block (prefix trees 4 levels deep where the first design
//     walked two chains of 16 dependent compare-and-adds). No divide beyond
//     range / tot and code / t;
//   - past 1,024 lanes each thread codes K/1,024 lanes in turn, their coder
//     state in global scratch (7 words a lane, the word loaded ahead among
//     them; the context and symbol packed beside the queue's count, so no
//     byte of the output is read back), and the update's atomics are
//     grouped a warp by __match_any_sync (update_step's GROUPED), so that a
//     thread's turns wait on fewer atomics.
// Measured and left out: the rows to halve listed by the update's returned
// atomics (a rescale only where rows crossed), the atomics grouped at 1,024
// lanes or fewer, and one warp a stream up to 32 lanes: each was slower, or
// no faster, at the corpus's shapes. The queue is L's (csrc/rc_exact.cu),
// copied into o1_model.cuh.
//
// What bounds it: the sequential steps; a lane's chain of two dependent
// divides, the block's shared reads and the count trees, three barriers,
// and the update's atomics, which runs of one byte put on few addresses.
#include "o1_model.cuh"

namespace {

using namespace o1;

// The blended block sums' inclusive prefixes of row r: they do not depend
// on v, so they are loaded and summed while the divides run.
__device__ __forceinline__ void block_prefixes(const Model& m, uint32_t r, int blend,
                                               uint32_t (&p)[16]) {
  const uint4* b1 = reinterpret_cast<const uint4*>(m.bsum1 + r * 16);
  const uint4* b0 = reinterpret_cast<const uint4*>(m.bsum0);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v1 = b1[q], v0 = b0[q];
#pragma unroll
    for (int k = 0; k < 4; ++k) p[4 * q + k] = (u4_at(v1, k) << blend) + u4_at(v0, k);
  }
  scan16(p);
}

// The decoder's search (the symbol s whose blended inclusive prefix is the
// first above v < tot_eff; c its exclusive prefix, f its blended count), as
// counts of compares, not chains: the block b is the number of block
// prefixes at or below v (the prefixes rise strictly: every count is at
// least 1), the largest of them is the prefix before b, and in block b
// likewise over its 16 counts. The same result as o1_model.cuh's search.
template <bool WIDE>
__device__ __forceinline__ uint32_t search_counted(const Model& m, uint32_t r, uint32_t v,
                                                   int blend, const uint32_t (&p)[16],
                                                   uint32_t& c, uint32_t& f) {
  uint32_t le[16], below[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const bool at = k < 15 && p[k] <= v;  // p[15] = tot_eff > v
    le[k] = at;
    below[k] = at ? p[k] : 0u;
  }
  const uint32_t b = tree(le, Add()), acc = tree(below, Max());
  uint32_t e1[16], e0[16];
  t1_block<WIDE>(m, r, b, e1);
  t0_block(m, b, e0);
#pragma unroll
  for (int k = 0; k < 16; ++k) e1[k] = (e1[k] << blend) + e0[k];
  scan16(e1);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const uint32_t q = acc + e1[k];
    const bool at = q <= v;
    le[k] = at;
    below[k] = at ? q : acc;
    e0[k] = at ? FULL : q;
  }
  const uint32_t cnt = tree(le, Add());
  c = tree(below, Max());
  f = tree(e0, Min()) - c;
  // cnt <= 15 wherever the model's sums agree (the count at v's place
  // rises past v); the clamp keeps a symbol inside the tables regardless
  return 16 * b + min(cnt, 15u);
}

// One lane's coding step: the refill (the word loaded a refill ahead goes
// into the queue, and the next one is loaded), the search, the renorm.
// -> the symbol; bad set where t = range / tot is 0.
template <bool WIDE>
__device__ __forceinline__ uint32_t code_step(const Model& m, const uint32_t* __restrict__ words,
                                              int K, int l4, int lane, uint32_t ctx,
                                              uint32_t tot0, int blend, uint32_t& rng,
                                              uint32_t& code, uint32_t& occ, uint32_t& widx,
                                              uint64_t& q, uint32_t& nw, bool& bad) {
  if (occ < (uint32_t)SLOTS) {
    q = (q << 32) | nw;
    occ += 4;
    nw = widx < (uint32_t)l4 ? words[(size_t)widx * K + lane] : 0u;
    ++widx;
  }
  const uint32_t r = m.rowtot[ctx];
  const uint32_t tot = (r << blend) + tot0;
  uint32_t p[16];
  block_prefixes(m, ctx, blend, p);
  const uint32_t t = rng / tot;
  // off the chain: tot in 64 bits past 2^32 - 1, or t = 0 (a step past
  // either runs on, with t = 0 or t from a wrapped tot: nothing after it
  // counts, and every index stays clamped)
  bad = ((uint64_t)r << blend) + tot0 > FULL || t == 0u;
  uint32_t v = code / t;
  v = v < tot - 1 ? v : tot - 1;
  uint32_t c, f;
  const uint32_t sym = search_counted<WIDE>(m, ctx, v, blend, p, c, f);
  code -= t * c;
  rng = (c + f == tot) ? rng - t * c : t * f;
  renorm_decode(code, rng, occ, q);
  return sym;
}

// words [l4, K] u32 big-endian word rows (l4 >= 1); lane_len [K] i32; out
// [n] u8; t1g as kernel U's; st [7][K] u32 (MULTI: range, code, occ | ctx
// << 8 | sym << 16, widx, the queue's low and high words, the word loaded
// ahead) or null; flag gets the first step with t = 0.
template <bool WIDE, bool MULTI>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    o1_decode_kernel(const uint32_t* __restrict__ words, const int32_t* __restrict__ lane_len,
                     uint8_t* __restrict__ out, uint32_t* t1g, uint32_t* __restrict__ st,
                     unsigned long long* __restrict__ flag, int K, int l4, int L, uint32_t inc,
                     uint32_t limit1, uint32_t limit0, int blend) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Model m = carve(smem, t1g, WIDE);
  const int tid = threadIdx.x, T = blockDim.x;
  const int lpt = MULTI ? K / T : 1;
  uint32_t rng = FULL, code = 0, occ = 0, widx = 2, ctx = 0, nw = 0;
  uint64_t q = 0;
  int len = 0;
  unsigned long long first = NONE;  // the least step of this thread's lanes with t = 0
  if (MULTI) {
    for (int lane = tid; lane < K; lane += T) {
      st[lane] = FULL;
      st[K + lane] = words[lane];
      st[2 * K + lane] = 0;
      st[3 * K + lane] = 2;
      st[4 * K + lane] = 0;
      st[5 * K + lane] = 0;
      st[6 * K + lane] = l4 > 1 ? words[K + lane] : 0u;
    }
  } else if (tid < K) {
    code = words[tid];
    nw = l4 > 1 ? words[K + tid] : 0u;
    len = lane_len[tid];
  }
  init_model<WIDE>(m);
  for (int j = 0; j < L; ++j) {
    rescale<WIDE>(m, limit1, limit0);
    const uint32_t tot0 = *m.tot0;
    uint32_t sym = 0;
    for (int mm = 0; mm < lpt; ++mm) {
      const int lane = tid + mm * T;
      if (MULTI) {
        if (j >= lane_len[lane]) continue;
        rng = st[lane], code = st[K + lane];
        const uint32_t packed = st[2 * K + lane];
        widx = st[3 * K + lane], nw = st[6 * K + lane];
        q = (uint64_t)st[5 * K + lane] << 32 | st[4 * K + lane];
        occ = packed & 0xFFu;
        ctx = packed >> 16;
      } else if (j >= len) {
        continue;
      }
      bool bad;
      sym = code_step<WIDE>(m, words, K, l4, lane, ctx, tot0, blend, rng, code, occ, widx, q, nw,
                            bad);
      first = first_bad(first, bad, j, lane);
      out[(size_t)lane * L + j] = (uint8_t)sym;
      if (MULTI) {
        st[lane] = rng, st[K + lane] = code, st[2 * K + lane] = occ | ctx << 8 | sym << 16;
        st[3 * K + lane] = widx, st[4 * K + lane] = (uint32_t)q;
        st[5 * K + lane] = (uint32_t)(q >> 32), st[6 * K + lane] = nw;
      }
    }
    __syncthreads();
    for (int mm = 0; mm < lpt; ++mm) {
      const int lane = tid + mm * T;
      bool active;
      uint32_t r = ctx;
      if (MULTI) {
        active = j < lane_len[lane];
        const uint32_t packed = active ? st[2 * K + lane] : 0u;
        r = (packed >> 8) & 0xFFu;
        sym = packed >> 16;
      } else {
        active = j < len;
      }
      update_step<WIDE, MULTI>(m, active, r, sym, inc);
      if (!MULTI && active) ctx = sym;
    }
    __syncthreads();
  }
  report_steps(flag, first);
}

template <bool WIDE, bool MULTI>
cudaError_t launch(const void* words, const void* lane_len, void* out, void* t1g, void* st,
                   void* flag, int K, int l4, int L, uint32_t inc, uint32_t limit1,
                   uint32_t limit0, int blend, cudaStream_t stream) {
  const int smem = smem_bytes(WIDE);
  cudaError_t err = cudaFuncSetAttribute(o1_decode_kernel<WIDE, MULTI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  o1_decode_kernel<WIDE, MULTI><<<1, cta_threads(K), smem, stream>>>(
      (const uint32_t*)words, (const int32_t*)lane_len, (uint8_t*)out, (uint32_t*)t1g,
      (uint32_t*)st, (unsigned long long*)flag, K, l4, L, inc, limit1, limit0, blend);
  return cudaGetLastError();
}

}  // namespace

// words [l4, K] u32 (big-endian word rows), lane_len [K] i32 -> out [n] u8
// (byte i*L + j is lane i's step j). t1 as for ct_o1_encode; st [7*K] u32
// scratch past 1,024 lanes, else null; flag one u64, all ones, which gets
// the first (step << 32 | lane) whose t is 0.
extern "C" int ct_o1_decode(const void* words, const void* lane_len, void* out, void* t1,
                            void* st, void* flag, int K, int l4, int L, int inc, int limit1_log2,
                            int limit0_log2, int blend_log2, int wide, void* stream) {
  if (K < 1 || K > 65536 || (K & (K - 1)) || l4 < 1 || L < 0 ||
      bad_header(inc, limit1_log2, limit0_log2, blend_log2) || (wide && t1 == nullptr) ||
      flag == nullptr || (K > MAX_THREADS && st == nullptr))
    return (int)cudaErrorInvalidValue;
  const uint32_t u = (uint32_t)inc;
  const uint32_t l1 = limit_of(limit1_log2), l0 = limit_of(limit0_log2);
  const cudaStream_t s = (cudaStream_t)stream;
  const bool multi = K > MAX_THREADS;
  if (wide)
    return (int)(multi ? launch<true, true>(words, lane_len, out, t1, st, flag, K, l4, L, u, l1,
                                            l0, blend_log2, s)
                       : launch<true, false>(words, lane_len, out, t1, st, flag, K, l4, L, u, l1,
                                             l0, blend_log2, s));
  return (int)(multi ? launch<false, true>(words, lane_len, out, t1, st, flag, K, l4, L, u, l1,
                                           l0, blend_log2, s)
                     : launch<false, false>(words, lane_len, out, t1, st, flag, K, l4, L, u, l1,
                                            l0, blend_log2, s));
}
