// Kernel U: CT-RC3 (the order-1 blended adaptive range coder) encode on
// Hopper.
//
// It replaces no Pallas kernel: the JAX package runs this coder as one
// compiled lax.scan (cpprcoder_tpu/ops/o1_ops.py:132 `_encode_fn`, scan
// :156), reading the model's rows with one-hot matrix products.
//
// What it computes, per stream of n bytes over K chunked lanes (lane i codes
// x[i*L + j] at step j < lane_len[i]; its context is its previous byte, 0 at
// j = 0): with the shared model of o1_model.cuh rescaled before the step,
// each active lane codes its symbol s against f = A*t1[ctx][s] + t0[s],
// c = A*C1[ctx][s] + C0[s], tot = A*rowtot[ctx] + tot0 (A = 2^blend):
// t = range / tot; low += t*c; range = (c + f == tot) ? range - t*c : t*f;
// then up to 3 shift_lows while range < 2^24 (3 suffice within C8's bound,
// which the wrapper enforces: tot <= 2^24, so t >= 1). One packed event a
// slot, time-major [3*L + 2, K] (ops/rc_common.py's format, which kernel B
// expands), then two flush rows. After the step every active lane adds inc
// to the model.
//
// Design. The lanes share the model and change it every step, so a stream
// is one CTA: a thread a lane up to 1,024 lanes (at least 256 threads, for
// the rescale's warps); past that each thread codes K / 1,024 lanes in turn,
// their coder state in global scratch between steps. Each step is the three
// phases of o1_model.cuh between barriers: rescale, code, update. The
// divide range / tot is a real 32-bit divide (tot differs by lane).
//
// What bounds it: the steps are sequential, and each is three barriers of
// the CTA, the rescale's row checks, a lane's prefix reads (about 30 shared
// loads), two divides and the atomics of the update, contended where many
// lanes share a context; at K = 256 (kennedy.xls) one CTA of the card's 132
// SMs works.
#include "o1_model.cuh"

namespace {

using namespace o1;

// x [L, K] u8; lane_len [K] i32; ev [3*L + 2, K] u32; t1g [65536] u32 (WIDE)
// or null; st [5][K] u32 (MULTI: the lanes' low, carry, range, cache,
// cache size) or null.
template <bool WIDE, bool MULTI>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    o1_encode_kernel(const uint8_t* __restrict__ x, const int32_t* __restrict__ lane_len,
                     uint32_t* __restrict__ ev, uint32_t* t1g, uint32_t* __restrict__ st, int K,
                     int L, uint32_t inc, uint32_t limit1, uint32_t limit0, int blend) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Model m = carve(smem, t1g, WIDE);
  const int tid = threadIdx.x, T = blockDim.x;
  const int lpt = MULTI ? K / T : 1;
  uint32_t low = 0, carry = 0, rng = FULL, cache = 0, csize = 1;
  if (MULTI) {
    for (int lane = tid; lane < K; lane += T) {
      st[lane] = 0;
      st[K + lane] = 0;
      st[2 * K + lane] = FULL;
      st[3 * K + lane] = 0;
      st[4 * K + lane] = 1;
    }
  }
  init_model<WIDE>(m);
  for (int j = 0; j < L; ++j) {
    rescale<WIDE>(m, limit1, limit0);
    const uint32_t tot0 = *m.tot0;
    for (int mm = 0; mm < lpt; ++mm) {
      const int lane = tid + mm * T;
      if (lane >= K) continue;
      uint32_t e[SLOTS] = {0u, 0u, 0u};
      if (j < lane_len[lane]) {
        if (MULTI) {
          low = st[lane], carry = st[K + lane], rng = st[2 * K + lane];
          cache = st[3 * K + lane], csize = st[4 * K + lane];
        }
        const uint32_t s = x[(size_t)j * K + lane];
        const uint32_t r = j ? x[(size_t)(j - 1) * K + lane] : 0u;
        uint32_t c, f, tot;
        lookup<WIDE>(m, r, s, blend, tot0, c, f, tot);
        const uint32_t t = rng / tot;
        const uint32_t add = t * c;
        const uint32_t nl = low + add;
        carry |= nl < low ? 1u : 0u;
        low = nl;
        rng = (c + f == tot) ? rng - add : t * f;
        renorm_encode(low, carry, rng, cache, csize, e);
        if (MULTI) {
          st[lane] = low, st[K + lane] = carry, st[2 * K + lane] = rng;
          st[3 * K + lane] = cache, st[4 * K + lane] = csize;
        }
      }
      uint32_t* evj = ev + (size_t)j * SLOTS * K + lane;
#pragma unroll
      for (int sl = 0; sl < SLOTS; ++sl) evj[(size_t)sl * K] = e[sl];
    }
    __syncthreads();
    for (int mm = 0; mm < lpt; ++mm) {
      const int lane = tid + mm * T;
      const bool active = lane < K && j < lane_len[lane];
      uint32_t r = 0, s = 0;
      if (active) {
        s = x[(size_t)j * K + lane];
        r = j ? x[(size_t)(j - 1) * K + lane] : 0u;
      }
      update_step<WIDE, false>(m, active, r, s, inc);
    }
    __syncthreads();
  }
  // flush: round low up to a multiple of 2^24, then shift_low twice
  uint32_t* fl = ev + (size_t)SLOTS * L * K;
  for (int mm = 0; mm < lpt; ++mm) {
    const int lane = tid + mm * T;
    if (lane >= K) continue;
    if (MULTI) {
      low = st[lane], carry = st[K + lane];
      cache = st[3 * K + lane], csize = st[4 * K + lane];
    }
    const uint32_t nl = low + ((0u - low) & 0xFFFFFFu);
    carry |= nl < low ? 1u : 0u;
    low = nl;
    fl[lane] = shift_low(low, carry, cache, csize);
    fl[K + lane] = shift_low(low, carry, cache, csize);
  }
}

template <bool WIDE, bool MULTI>
cudaError_t launch(const void* x, const void* lane_len, void* ev, void* t1g, void* st, int K,
                   int L, uint32_t inc, uint32_t limit1, uint32_t limit0, int blend,
                   cudaStream_t stream) {
  const int smem = smem_bytes(WIDE);
  cudaError_t err = cudaFuncSetAttribute(o1_encode_kernel<WIDE, MULTI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  o1_encode_kernel<WIDE, MULTI><<<1, cta_threads(K), smem, stream>>>(
      (const uint8_t*)x, (const int32_t*)lane_len, (uint32_t*)ev, (uint32_t*)t1g,
      (uint32_t*)st, K, L, inc, limit1, limit0, blend);
  return cudaGetLastError();
}

}  // namespace

// x [L, K] u8 (chunked lanes), lane_len [K] i32 -> ev [3*L + 2, K] u32.
// t1 [65536] u32 scratch when wide (a t1 count may reach 2^16), else null;
// st [5*K] u32 scratch when K > 1,024, else null. K a power of two up to
// 65,536; the caller has checked C8's bound (o1_ops.check_params).
extern "C" int ct_o1_encode(const void* x, const void* lane_len, void* ev, void* t1, void* st,
                            int K, int L, int inc, int limit1_log2, int limit0_log2,
                            int blend_log2, int wide, void* stream) {
  if (K < 1 || K > 65536 || (K & (K - 1)) || L < 0 || inc < 0 || inc > 255 || limit1_log2 < 0 ||
      limit1_log2 > 31 || limit0_log2 < 0 || limit0_log2 > 31 || blend_log2 < 0 ||
      blend_log2 > 24 || (wide && t1 == nullptr) || (K > MAX_THREADS && st == nullptr))
    return (int)cudaErrorInvalidValue;
  const uint32_t u = (uint32_t)inc, l1 = 1u << limit1_log2, l0 = 1u << limit0_log2;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool multi = K > MAX_THREADS;
  if (wide)
    return (int)(multi ? launch<true, true>(x, lane_len, ev, t1, st, K, L, u, l1, l0, blend_log2, s)
                       : launch<true, false>(x, lane_len, ev, t1, st, K, L, u, l1, l0, blend_log2, s));
  return (int)(multi ? launch<false, true>(x, lane_len, ev, t1, st, K, L, u, l1, l0, blend_log2, s)
                     : launch<false, false>(x, lane_len, ev, t1, st, K, L, u, l1, l0, blend_log2, s));
}
