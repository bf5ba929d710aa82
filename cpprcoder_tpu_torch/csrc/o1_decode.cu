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
// (its previous symbol, 0 at j = 0) takes tot = A*rowtot[ctx] + tot0,
// t = range / tot, v = min(code / t, tot - 1), and the symbol s whose
// blended inclusive prefix is the first above v; code -= t*c; range =
// (c + f == tot) ? range - t*c : t*f; up to 3 bytes from the queue while
// range < 2^24. s goes to out[i*L + j]; then every active lane adds inc to
// the model, as the encoder does.
//
// Design. As kernel U's: one CTA a stream, a thread a lane up to 1,024
// lanes, more lanes in turn with their state in global scratch; the three
// phases between barriers. The search walks the 16 block sums of the row
// (blended with t0's) to the block that holds v, then its 16 counts: about
// 30 shared reads and compares, no divide beyond range / tot and code / t.
// The queue is L's (csrc/rc_exact.cu), copied into o1_model.cuh.
//
// What bounds it: as U, the sequential steps, three barriers each, with the
// search and two divides on a lane's chain.
#include "o1_model.cuh"

namespace {

using namespace o1;

// words [l4, K] u32 big-endian word rows (l4 >= 1); lane_len [K] i32; out
// [n] u8; t1g as kernel U's; st [6][K] u32 (MULTI: range, code, occ,
// widx, the queue's low and high words) or null.
template <bool WIDE, bool MULTI>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    o1_decode_kernel(const uint32_t* __restrict__ words, const int32_t* __restrict__ lane_len,
                     uint8_t* __restrict__ out, uint32_t* t1g, uint32_t* __restrict__ st, int K,
                     int l4, int L, uint32_t inc, uint32_t limit1, uint32_t limit0, int blend) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Model m = carve(smem, t1g, WIDE);
  const int tid = threadIdx.x, T = blockDim.x;
  const int lpt = MULTI ? K / T : 1;
  uint32_t rng = FULL, code = 0, occ = 0, widx = 1, ctx = 0, sym = 0;
  uint64_t q = 0;
  if (MULTI) {
    for (int lane = tid; lane < K; lane += T) {
      st[lane] = FULL;
      st[K + lane] = words[lane];
      st[2 * K + lane] = 0;
      st[3 * K + lane] = 1;
      st[4 * K + lane] = 0;
      st[5 * K + lane] = 0;
    }
  } else if (tid < K) {
    code = words[tid];
  }
  init_model<WIDE>(m);
  for (int j = 0; j < L; ++j) {
    rescale<WIDE>(m, limit1, limit0);
    const uint32_t tot0 = *m.tot0;
    for (int mm = 0; mm < lpt; ++mm) {
      const int lane = tid + mm * T;
      if (lane >= K || j >= lane_len[lane]) continue;
      const size_t at = (size_t)lane * L + j;
      if (MULTI) {
        rng = st[lane], code = st[K + lane], occ = st[2 * K + lane], widx = st[3 * K + lane];
        q = (uint64_t)st[5 * K + lane] << 32 | st[4 * K + lane];
        ctx = j ? out[at - 1] : 0u;
      }
      if (occ < (uint32_t)SLOTS) {
        const uint32_t w = widx < (uint32_t)l4 ? words[(size_t)widx * K + lane] : 0u;
        q = (q << 32) | w;
        occ += 4;
        ++widx;
      }
      const uint32_t tot = (m.rowtot[ctx] << blend) + tot0;
      const uint32_t t = rng / tot;
      uint32_t v = code / t;
      v = v < tot - 1 ? v : tot - 1;
      uint32_t c, f;
      sym = search<WIDE>(m, ctx, v, blend, c, f);
      code -= t * c;
      rng = (c + f == tot) ? rng - t * c : t * f;
      renorm_decode(code, rng, occ, q);
      out[at] = (uint8_t)sym;
      if (MULTI) {
        st[lane] = rng, st[K + lane] = code, st[2 * K + lane] = occ, st[3 * K + lane] = widx;
        st[4 * K + lane] = (uint32_t)q, st[5 * K + lane] = (uint32_t)(q >> 32);
      }
    }
    __syncthreads();
    for (int mm = 0; mm < lpt; ++mm) {
      const int lane = tid + mm * T;
      const bool active = lane < K && j < lane_len[lane];
      if (active) {
        const size_t at = (size_t)lane * L + j;
        if (MULTI) {
          sym = out[at];
          ctx = j ? out[at - 1] : 0u;
        }
        update<WIDE>(m, ctx, sym, inc);
        ctx = sym;
      }
      count_active(m, active, inc);
    }
    __syncthreads();
  }
}

template <bool WIDE, bool MULTI>
cudaError_t launch(const void* words, const void* lane_len, void* out, void* t1g, void* st, int K,
                   int l4, int L, uint32_t inc, uint32_t limit1, uint32_t limit0, int blend,
                   cudaStream_t stream) {
  const int smem = smem_bytes(WIDE);
  cudaError_t err = cudaFuncSetAttribute(o1_decode_kernel<WIDE, MULTI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  o1_decode_kernel<WIDE, MULTI><<<1, cta_threads(K), smem, stream>>>(
      (const uint32_t*)words, (const int32_t*)lane_len, (uint8_t*)out, (uint32_t*)t1g,
      (uint32_t*)st, K, l4, L, inc, limit1, limit0, blend);
  return cudaGetLastError();
}

}  // namespace

// words [l4, K] u32 (big-endian word rows), lane_len [K] i32 -> out [n] u8
// (byte i*L + j is lane i's step j). t1 and st as for ct_o1_encode (st
// [6*K]).
extern "C" int ct_o1_decode(const void* words, const void* lane_len, void* out, void* t1,
                            void* st, int K, int l4, int L, int inc, int limit1_log2,
                            int limit0_log2, int blend_log2, int wide, void* stream) {
  if (K < 1 || K > 65536 || (K & (K - 1)) || l4 < 1 || L < 0 || inc < 0 || inc > 255 ||
      limit1_log2 < 0 || limit1_log2 > 31 || limit0_log2 < 0 || limit0_log2 > 31 ||
      blend_log2 < 0 || blend_log2 > 24 || (wide && t1 == nullptr) ||
      (K > MAX_THREADS && st == nullptr))
    return (int)cudaErrorInvalidValue;
  const uint32_t u = (uint32_t)inc, l1 = 1u << limit1_log2, l0 = 1u << limit0_log2;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool multi = K > MAX_THREADS;
  if (wide)
    return (int)(multi ? launch<true, true>(words, lane_len, out, t1, st, K, l4, L, u, l1, l0,
                                            blend_log2, s)
                       : launch<true, false>(words, lane_len, out, t1, st, K, l4, L, u, l1, l0,
                                             blend_log2, s));
  return (int)(multi ? launch<false, true>(words, lane_len, out, t1, st, K, l4, L, u, l1, l0,
                                           blend_log2, s)
                     : launch<false, false>(words, lane_len, out, t1, st, K, l4, L, u, l1, l0,
                                            blend_log2, s));
}
