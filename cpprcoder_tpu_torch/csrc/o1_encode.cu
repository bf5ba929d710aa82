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
// then up to 3 shift_lows while range < 2^24 (3 suffice wherever t >= 1:
// ops/o1_ops.py's docstring). tot is formed in 64 bits; a step with t = 0
// (tot above the range) is reported through a flag, the first (step, lane)
// of the call, and the wrapper raises. One packed event a slot, time-major
// [3*L + 2, K] (ops/rc_common.py's format, which kernel B expands), then
// two flush rows. After the step every active lane adds inc to the
// model. The model's counts and totals are u32, or u64 where one can reach
// 2^32 - 1 (the FORM_LONG instantiation, o1_model.cuh: fault P7's repair).
//
// Design (second round; the first ran the coder inside the model's step).
// The model never reads the coder, so U is two passes, as CT-ANS2's encode
// is W and X:
//   - the model pass (o1_model_kernel): all lanes share the model and change
//     it every step, so a stream is one CTA, a thread a lane up to 1,024
//     lanes (at least 256 threads, for the rescale's warps; past 1,024 each
//     thread takes K / 1,024 lanes in turn; launch bounds of 256 threads up
//     to 256 lanes, so that the kernel is not held to 64 registers there). A
//     step is o1_model.cuh's three phases between barriers: the rescale
//     (from 128 lanes on with t0's prefix sums scanned by one warp: T0SCAN,
//     so that the update adds to t0 alone, not to its block sums and
//     total), the lookup (prefix trees) and the update. Each lane's next
//     symbol is loaded a step ahead into a register (its context is its
//     last symbol) and its length read once. It writes each lane's (c, f, tot) as three u32 planes
//     [steps][3][K] (0 where the lane has ended); no divide, no coder state;
//   - the coder pass (o1_coder_kernel): a thread a lane over the card in
//     CTAs of 64, each lane's triples read a run of AHEAD steps ahead of its
//     chain (the divide and renorm_encode), its events written as before.
// The two alternate over chunks of at most `chunk` steps (the wrapper cuts
// a stream in 8), so the triples' scratch stays below a fixed size
// whatever the input (o1_kernels.TRIPLE_BYTES, two buffers); a chunk's
// coder pass runs on a side stream beside the next chunk's model pass (so
// only the last chunk's waits), and between chunks the model goes to
// global memory (mstate) and the lanes' coder state too (st: 5 words a
// lane). Measured and left out (PERF.md, section 6): the model kernel with
// the coder inline (one kernel: slower at every shape timed), the passes
// in turn on one stream (variant u_serial), and the update's groups
// formed a step ahead by __match_any_sync (slower at every shape timed:
// the match costs most where a warp's keys are distinct, as its inactive
// lanes' are).
//
// What bounds it: the model pass's sequential steps, each three barriers of
// the CTA, the rescale's row checks, a lane's two levels of shared reads and
// the atomics of the update (runs of one byte pair put them on few
// addresses); one CTA of the card's 132 SMs works. The coder pass is a
// chain of a divide and the renorm a step a lane.
#include <mutex>

#include "o1_model.cuh"

namespace {

using namespace o1;

// t0's prefix sums scanned in the rescale from this many lanes on: below,
// few lanes add to t0's block sums and total at little cost, and the scan
// lengthens every step's rescale (on the H100: 0.70 ms faster at 256 lanes,
// 0.09 ms faster at 128, 0.11 ms slower at 64, within 0.3% at 2,048 and
// 65,536; PERF.md, section 6)
constexpr int T0SCAN_LANES = 128;
constexpr int CODER_THREADS = 64;
constexpr int AHEAD = 8;  // the coder's triples read a run of AHEAD steps ahead

// A lane's coder state: low, carry, range, cache, cache size.
struct Coder {
  uint32_t low, carry, rng, cache, csize;
};

__device__ __forceinline__ Coder coder_start() { return Coder{0u, 0u, FULL, 0u, 1u}; }

// st [5][K]: the lanes' coder states between chunks.
__device__ __forceinline__ Coder coder_load(const uint32_t* st, int K, int lane) {
  return Coder{st[lane], st[K + lane], st[2 * K + lane], st[3 * K + lane], st[4 * K + lane]};
}

__device__ __forceinline__ void coder_store(const Coder& q, uint32_t* st, int K, int lane) {
  st[lane] = q.low, st[K + lane] = q.carry, st[2 * K + lane] = q.rng;
  st[3 * K + lane] = q.cache, st[4 * K + lane] = q.csize;
}

// One symbol (c, f, tot) coded into the step's SLOTS events; tot = 0 (a
// lane that has ended) codes nothing and emits nothing. -> false where t =
// 0, or f = 0 (the model pass's mark of a tot past 2^32 - 1): the coder
// does not end there.
__device__ __forceinline__ bool code_symbol(Coder& q, uint32_t c, uint32_t f, uint32_t tot,
                                            uint32_t (&e)[SLOTS]) {
#pragma unroll
  for (int sl = 0; sl < SLOTS; ++sl) e[sl] = 0u;
  if (tot == 0) return true;
  const uint32_t t = q.rng / tot;
  const uint32_t add = t * c;
  const uint32_t nl = q.low + add;
  q.carry |= nl < q.low ? 1u : 0u;
  q.low = nl;
  q.rng = (c + f == tot) ? q.rng - add : t * f;
  renorm_encode(q.low, q.carry, q.rng, q.cache, q.csize, e);
  return t != 0u && f != 0u;
}

// The flush: low rounded up to a multiple of 2^24, then two shift_lows
// into the flush rows fl[lane], fl[K + lane].
__device__ __forceinline__ void flush(Coder& q, uint32_t* fl, int K, int lane) {
  const uint32_t nl = q.low + ((0u - q.low) & 0xFFFFFFu);
  q.carry |= nl < q.low ? 1u : 0u;
  q.low = nl;
  fl[lane] = shift_low(q.low, q.carry, q.cache, q.csize);
  fl[K + lane] = shift_low(q.low, q.carry, q.cache, q.csize);
}

__device__ __forceinline__ void store_events(uint32_t* ev, int K, int j, int lane,
                                             const uint32_t (&e)[SLOTS]) {
  uint32_t* evj = ev + (size_t)j * SLOTS * K + lane;
#pragma unroll
  for (int sl = 0; sl < SLOTS; ++sl) evj[(size_t)sl * K] = e[sl];
}

// The model pass over steps [j0, j1): x [L, K] u8, lane_len [K] i32 ->
// trip [j1 - j0][3][K] u32, each lane's (c, f, tot) (0 where it has
// ended). The model starts fresh at j0 = 0, else from mstate, and goes to
// mstate where j1 < L. t1g [65536] C holds t1 where WIDE.
template <bool WIDE, bool MULTI, int MAXT, bool T0SCAN, class C>
__global__ void __launch_bounds__(MAXT, 1)
    o1_model_kernel(const uint8_t* __restrict__ x, const int32_t* __restrict__ lane_len,
                    uint32_t* __restrict__ trip, uint32_t* t1g, uint32_t* __restrict__ mstate,
                    int K, int L, int j0, int j1, uint32_t inc, C limit1, C limit0, int blend) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Model<C> m = carve<C>(smem, t1g, WIDE);
  const int tid = threadIdx.x, T = blockDim.x;
  if (j0 == 0)
    init_model<WIDE>(m);
  else
    copy_model<WIDE, C>(reinterpret_cast<uint4*>(smem), reinterpret_cast<const uint4*>(mstate));
  if (!MULTI) {
    const int lane = tid;
    const int len = lane < K ? lane_len[lane] : 0;
    bool act = j0 < len;
    uint32_t s = act ? x[(size_t)j0 * K + lane] : 0u;
    uint32_t ctx = act && j0 > 0 ? x[(size_t)(j0 - 1) * K + lane] : 0u;
    for (int j = j0; j < j1; ++j) {
      // the symbol a step ahead
      const bool next = j + 1 < len;
      const uint32_t sn = next ? x[(size_t)(j + 1) * K + lane] : 0u;
      rescale<WIDE, T0SCAN>(m, limit1, limit0);
      uint32_t c = 0, f = 0, tot = 0;
      if (act) lookup<WIDE, T0SCAN>(m, ctx, s, blend, *m.tot0, c, f, tot);
      if (lane < K) {
        uint32_t* tp = trip + (size_t)(j - j0) * 3 * K + lane;
        tp[0] = c;
        tp[K] = f;
        tp[2 * K] = tot;
      }
      __syncthreads();
      update_step<WIDE, false, T0SCAN>(m, act, ctx, s, inc);
      ctx = s;
      s = sn;
      act = next;
      __syncthreads();
    }
  } else {
    // K / T lanes a thread, in turns: each turn reads its lane's symbol and
    // context (global, then L1), in the update again
    const int lpt = K / T;
    for (int j = j0; j < j1; ++j) {
      rescale<WIDE, T0SCAN>(m, limit1, limit0);
      const C tot0 = *m.tot0;
      for (int mm = 0; mm < lpt; ++mm) {
        const int lane = tid + mm * T;
        uint32_t c = 0, f = 0, tot = 0;
        if (j < lane_len[lane]) {
          const uint32_t s = __ldg(x + (size_t)j * K + lane);
          const uint32_t r = j ? __ldg(x + (size_t)(j - 1) * K + lane) : 0u;
          lookup<WIDE, T0SCAN>(m, r, s, blend, tot0, c, f, tot);
        }
        uint32_t* tp = trip + (size_t)(j - j0) * 3 * K + lane;
        tp[0] = c;
        tp[K] = f;
        tp[2 * K] = tot;
      }
      __syncthreads();
      for (int mm = 0; mm < lpt; ++mm) {
        const int lane = tid + mm * T;
        const bool active = j < lane_len[lane];
        uint32_t r = 0, s = 0;
        if (active) {
          s = __ldg(x + (size_t)j * K + lane);
          r = j ? __ldg(x + (size_t)(j - 1) * K + lane) : 0u;
        }
        update_step<WIDE, true, T0SCAN>(m, active, r, s, inc);
      }
      __syncthreads();
    }
  }
  if (j1 < L)
    copy_model<WIDE, C>(reinterpret_cast<uint4*>(mstate), reinterpret_cast<const uint4*>(smem));
}

// The coder pass over steps [j0, j1): trip [j1 - j0][3][K] -> ev rows
// [3*j0, 3*j1); the lanes' state from st where j0 > 0, to st where j1 < L,
// else the two flush rows. A thread a lane: the triples of the next run of
// AHEAD steps are loaded while this run codes. The lane's first step with
// t = 0 goes to *flag at its end.
__global__ void __launch_bounds__(CODER_THREADS)
    o1_coder_kernel(const uint32_t* __restrict__ trip, uint32_t* __restrict__ ev,
                    uint32_t* __restrict__ st, unsigned long long* __restrict__ flag, int K,
                    int L, int j0, int j1) {
  const int lane = blockIdx.x * CODER_THREADS + threadIdx.x;
  if (lane >= K) return;
  unsigned long long first = NONE;
  Coder q = j0 == 0 ? coder_start() : coder_load(st, K, lane);
  const int n = j1 - j0;
  const uint32_t* tp = trip + lane;
  const size_t row = (size_t)3 * K;
  uint32_t c[AHEAD], f[AHEAD], t[AHEAD];
#pragma unroll
  for (int u = 0; u < AHEAD; ++u) {
    const bool in = u < n;
    c[u] = in ? tp[u * row] : 0u;
    f[u] = in ? tp[u * row + K] : 0u;
    t[u] = in ? tp[u * row + 2 * K] : 0u;
  }
  for (int i = 0; i < n; i += AHEAD) {
    uint32_t cn[AHEAD], fn[AHEAD], tn[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const int k = i + AHEAD + u;
      const bool in = k < n;
      cn[u] = in ? tp[k * row] : 0u;
      fn[u] = in ? tp[k * row + K] : 0u;
      tn[u] = in ? tp[k * row + 2 * K] : 0u;
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      if (i + u < n) {
        uint32_t e[SLOTS];
        const bool good = code_symbol(q, c[u], f[u], t[u], e);
        first = first_bad(first, !good, j0 + i + u, lane);
        store_events(ev, K, j0 + i + u, lane, e);
      }
      c[u] = cn[u], f[u] = fn[u], t[u] = tn[u];
    }
  }
  if (j1 < L)
    coder_store(q, st, K, lane);
  else
    flush(q, ev + (size_t)SLOTS * L * K, K, lane);
  report_steps(flag, first);
}

template <bool WIDE, bool MULTI, int MAXT, bool T0SCAN, class C>
cudaError_t launch_model(const void* x, const void* lane_len, void* trip, void* t1g, void* mstate,
                         int K, int L, int j0, int j1, uint32_t inc, int limit1_log2,
                         int limit0_log2, int blend, cudaStream_t stream) {
  const int smem = smem_bytes<C>(WIDE);
  cudaError_t err = cudaFuncSetAttribute(o1_model_kernel<WIDE, MULTI, MAXT, T0SCAN, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  o1_model_kernel<WIDE, MULTI, MAXT, T0SCAN, C><<<1, cta_threads(K), smem, stream>>>(
      (const uint8_t*)x, (const int32_t*)lane_len, (uint32_t*)trip, (uint32_t*)t1g,
      (uint32_t*)mstate, K, L, j0, j1, inc, limit_of<C>(limit1_log2), limit_of<C>(limit0_log2),
      blend);
  return cudaGetLastError();
}

template <bool WIDE, class C>
cudaError_t model_of_form(const void* x, const void* lane_len, void* trip, void* t1g,
                          void* mstate, int K, int L, int j0, int j1, uint32_t inc, int l1,
                          int l0, int blend, cudaStream_t s) {
  // a CTA of 256 threads may keep more registers a thread than one of 1,024
  if (K > MAX_THREADS)
    return launch_model<WIDE, true, MAX_THREADS, true, C>(x, lane_len, trip, t1g, mstate, K, L,
                                                          j0, j1, inc, l1, l0, blend, s);
  if (K > MIN_THREADS)
    return launch_model<WIDE, false, MAX_THREADS, true, C>(x, lane_len, trip, t1g, mstate, K, L,
                                                           j0, j1, inc, l1, l0, blend, s);
  if (K >= T0SCAN_LANES)
    return launch_model<WIDE, false, MIN_THREADS, true, C>(x, lane_len, trip, t1g, mstate, K, L,
                                                           j0, j1, inc, l1, l0, blend, s);
  return launch_model<WIDE, false, MIN_THREADS, false, C>(x, lane_len, trip, t1g, mstate, K, L,
                                                          j0, j1, inc, l1, l0, blend, s);
}

cudaError_t model(const void* x, const void* lane_len, void* trip, void* t1g, void* mstate, int K,
                  int L, int j0, int j1, uint32_t inc, int l1, int l0, int blend, int form,
                  cudaStream_t s) {
  switch (form) {
    case 0:
      return model_of_form<false, uint32_t>(x, lane_len, trip, t1g, mstate, K, L, j0, j1, inc,
                                            l1, l0, blend, s);
    case FORM_WIDE:
      return model_of_form<true, uint32_t>(x, lane_len, trip, t1g, mstate, K, L, j0, j1, inc, l1,
                                           l0, blend, s);
    case FORM_LONG:
      return model_of_form<false, u64>(x, lane_len, trip, t1g, mstate, K, L, j0, j1, inc, l1, l0,
                                       blend, s);
    default:
      return model_of_form<true, u64>(x, lane_len, trip, t1g, mstate, K, L, j0, j1, inc, l1, l0,
                                      blend, s);
  }
}

cudaError_t coder(const void* trip, void* ev, void* st, void* flag, int K, int L, int j0, int j1,
                  cudaStream_t s) {
  o1_coder_kernel<<<(K + CODER_THREADS - 1) / CODER_THREADS, CODER_THREADS, 0, s>>>(
      (const uint32_t*)trip, (uint32_t*)ev, (uint32_t*)st, (unsigned long long*)flag, K, L, j0,
      j1);
  return cudaGetLastError();
}

// The coder passes' stream and the events that order it against the
// caller's, one set a device, made at first use; ct_o1_encode holds the
// mutex while it enqueues, so that callers on several host threads do not
// interleave their records.
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t model_done[2] = {nullptr, nullptr};
  cudaEvent_t coder_done[2] = {nullptr, nullptr};
};
constexpr int MAX_DEVICES = 64;

std::mutex& side_mutex() {
  static std::mutex mu;
  return mu;
}

cudaError_t side_of_device(Side*& out) {
  static Side sides[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  Side& sd = sides[dev];
  if (sd.stream == nullptr) {
    Side made;
    e = cudaStreamCreateWithFlags(&made.stream, cudaStreamNonBlocking);
    for (int i = 0; i < 2 && e == cudaSuccess; ++i) {
      e = cudaEventCreateWithFlags(&made.model_done[i], cudaEventDisableTiming);
      if (e == cudaSuccess) e = cudaEventCreateWithFlags(&made.coder_done[i], cudaEventDisableTiming);
    }
    if (e != cudaSuccess) return e;
    sd = made;
  }
  out = &sd;
  return cudaSuccess;
}

bool bad_params(int K, int L, int inc, int limit1_log2, int limit0_log2, int blend_log2,
                int form) {
  return K < 1 || K > 65536 || (K & (K - 1)) || L < 0 || form < 0 ||
         form > (FORM_WIDE | FORM_LONG) || bad_header(inc, limit1_log2, limit0_log2, blend_log2);
}

}  // namespace

// x [L, K] u8 (chunked lanes), lane_len [K] i32 -> ev [3*L + 2, K] u32:
// the model and coder passes over chunks of at most `chunk` steps. Where
// there is more than one chunk, the coder pass of a chunk runs on a side
// stream beside the model pass of the next, the triples double-buffered,
// and the caller's stream waits for the last. form: FORM_WIDE where a t1
// count may reach 2^16, FORM_LONG where a count may reach 2^32 - 1
// (o1_ops's table_wide and counts_long). Scratch: t1 [65536] C (u32, or
// u64 with FORM_LONG) with FORM_WIDE, else null; st [5*K] u32; trip
// [2][chunk][3][K] u32 ([chunk][3][K] where chunk >= L); mstate
// smem_bytes<C>(wide) bytes where chunk < L, else null; flag one u64, all
// ones, which gets the first (step << 32 | lane) whose t is 0. K a power
// of two up to 65,536.
extern "C" int ct_o1_encode(const void* x, const void* lane_len, void* ev, void* t1, void* st,
                            void* trip, void* mstate, void* flag, int K, int L, int chunk,
                            int inc, int limit1_log2, int limit0_log2, int blend_log2, int form,
                            void* stream) {
  if (bad_params(K, L, inc, limit1_log2, limit0_log2, blend_log2, form) || chunk < 1 ||
      ((form & FORM_WIDE) && t1 == nullptr) || st == nullptr || trip == nullptr ||
      flag == nullptr || (chunk < L && mstate == nullptr))
    return (int)cudaErrorInvalidValue;
  const uint32_t u = (uint32_t)inc;
  const int l1 = limit1_log2, l0 = limit0_log2;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
  if (chunk >= L) {
    int j0 = 0;
    do {
      const int j1 = L - j0 < chunk ? L : j0 + chunk;
      if (j1 > j0)
        e = model(x, lane_len, trip, t1, mstate, K, L, j0, j1, u, l1, l0, blend_log2, form, s);
      if (e == cudaSuccess) e = coder(trip, ev, st, flag, K, L, j0, j1, s);
      if (e != cudaSuccess) return (int)e;
      j0 = j1;
    } while (j0 < L);
    return 0;
  }
  Side* side = nullptr;
  std::lock_guard<std::mutex> lock(side_mutex());
  if ((e = side_of_device(side)) != cudaSuccess) return (int)e;
  const size_t words = (size_t)chunk * 3 * K;
  int b = 0;
  for (int j0 = 0; j0 < L; j0 += chunk, b ^= 1) {
    const int j1 = L - j0 < chunk ? L : j0 + chunk;
    uint32_t* tb = (uint32_t*)trip + b * words;
    // buffer b is free once the coder pass two chunks back has read it
    if (j0 >= 2 * chunk) e = cudaStreamWaitEvent(s, side->coder_done[b], 0);
    if (e == cudaSuccess)
      e = model(x, lane_len, tb, t1, mstate, K, L, j0, j1, u, l1, l0, blend_log2, form, s);
    if (e == cudaSuccess) e = cudaEventRecord(side->model_done[b], s);
    if (e == cudaSuccess) e = cudaStreamWaitEvent(side->stream, side->model_done[b], 0);
    if (e == cudaSuccess) e = coder(tb, ev, st, flag, K, L, j0, j1, side->stream);
    if (e == cudaSuccess) e = cudaEventRecord(side->coder_done[b], side->stream);
    if (e != cudaSuccess) {
      // the caller frees the scratch on its stream once this returns: no
      // coder pass queued on the side stream may still be writing it
      cudaStreamSynchronize(side->stream);
      return (int)e;
    }
  }
  // the caller's stream goes on once the last coder pass is done
  return (int)cudaStreamWaitEvent(s, side->coder_done[b ^ 1], 0);
}

// The model pass alone over steps [j0, j1) (0 <= j0 < j1 <= L): trip
// [j1 - j0][3][K] u32; the model from mstate where j0 > 0, to it where
// j1 < L. Scratch as for ct_o1_encode.
extern "C" int ct_o1_model(const void* x, const void* lane_len, void* trip, void* t1,
                           void* mstate, int K, int L, int j0, int j1, int inc, int limit1_log2,
                           int limit0_log2, int blend_log2, int form, void* stream) {
  if (bad_params(K, L, inc, limit1_log2, limit0_log2, blend_log2, form) || j0 < 0 ||
      j1 <= j0 || j1 > L || ((form & FORM_WIDE) && t1 == nullptr) || trip == nullptr ||
      ((j0 > 0 || j1 < L) && mstate == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)model(x, lane_len, trip, t1, mstate, K, L, j0, j1, (uint32_t)inc, limit1_log2,
                    limit0_log2, blend_log2, form, (cudaStream_t)stream);
}

// The coder pass alone over steps [j0, j1) (0 <= j0 <= j1 <= L): trip
// [j1 - j0][3][K] u32 -> ev [3*L + 2, K] u32 rows 3*j0 to 3*j1 (and the
// flush rows where j1 = L); st [5*K] u32 the lanes' state between chunks;
// flag as for ct_o1_encode.
extern "C" int ct_o1_coder(const void* trip, void* ev, void* st, void* flag, int K, int L, int j0,
                           int j1, void* stream) {
  if (K < 1 || K > 65536 || (K & (K - 1)) || j0 < 0 || j1 < j0 || j1 > L || flag == nullptr ||
      (j1 > j0 && trip == nullptr) || ((j0 > 0 || j1 < L) && st == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)coder(trip, ev, st, flag, K, L, j0, j1, (cudaStream_t)stream);
}
