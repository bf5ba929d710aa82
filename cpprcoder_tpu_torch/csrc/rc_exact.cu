// Kernels J and L: CT-RC1 (static) and CT-RC2 (adaptive) range coding on
// Hopper.
//
// They replace no Pallas kernel: the JAX package runs these coders as one
// compiled lax.scan each on the device (cpprcoder_tpu/ops/range_ops.py:51-91
// CT-RC1 encode, :94-132 CT-RC2 encode, :273-311 CT-RC1 decode, :314-366
// CT-RC2 decode). The reference's byte loop is cpprcoder.h:400-436, 697-742.
//
// What they compute, per stream of n bytes over K interleaved lanes (lane i
// codes x[j*K + i] at step j, j < lane_len[i]):
//   - CT-RC1: one static table freqs[256] of total 2^16, t = range >> 16;
//   - CT-RC2: one adaptive table for all lanes, starting at freqs = 1. Before
//     each step, if total >= limit then freqs = (freqs >> 1) | 1; every
//     lane codes its symbol with t = range / total; then each active lane
//     adds inc to its symbol's count (integer adds commute, so the order of
//     the atomics does not matter);
//   - the coder: low += t*c; range = (c + f == total) ? range - t*c : t*f;
//     then up to SLOTS shift_lows while range < 2^24 (SLOTS = 3 where a
//     total above 2^16 can leave t*f at 2^6). Encode (J) writes one packed
//     event per slot, time-major [SLOTS*stride + 2, K], then two flush rows
//     (ops/rc_common.py's format, the one kernel B reads). Decode (L) takes
//     each lane's big-endian word row; a 64-bit queue takes a whole word
//     when fewer than SLOTS bytes are buffered (bytes past the lane's end
//     read as zero); the symbol is the largest s with cum[s] <= min(code / t,
//     total - 1), by a binary search over the shared cum row; lane i's step-j
//     byte goes to out[j*K + i].
//
// Design: the lanes of a stream share one table, so a stream is one CTA of
// up to 1024 threads, 1 to 8 lanes a thread (K <= 8192), lane state in
// registers. The table and its exclusive cum (257 entries, cum[256] = total)
// sit in shared memory; for CT-RC2 warp 0 rescales and scans them before
// each step (8 counts a lane, warp shuffles) between two barriers. The
// shift_low and event packing are kernel A's (rc_encode.cuh), copied here so
// that A, C, D and E compile as they did.
//
// What bounds it: a stream's steps are sequential, each a chain of a table
// read, a 32-bit divide (CT-RC2), the coder and, for CT-RC2, two barriers
// around warp 0's scan of the table. One stream occupies one SM: it is
// latency-bound.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t RC_TOP = 1u << 24;
constexpr uint32_t EV_RUN_MASK = (1u << 22) - 1;
constexpr uint32_t STATIC_TOTAL = 1u << 16;
constexpr uint32_t FULL = 0xFFFFFFFFu;
constexpr int MAX_THREADS = 1024;

__device__ __forceinline__ uint32_t shift_low(uint32_t& low, uint32_t& carry, uint32_t& cache,
                                              uint32_t& csize) {
  uint32_t ev = 0;
  if (low < 0xFF000000u || carry != 0) {
    const uint32_t first = (cache + carry) & 0xFFu;
    ev = 0x80000000u | (first << 23) | ((carry & 1u) << 22) | ((csize - 1u) & EV_RUN_MASK);
    cache = low >> 24;
    csize = 0;
    carry = 0;
  }
  csize += 1;
  low <<= 8;
  return ev;
}

// Warp 0 only: the table of the coming step. ADAPTIVE rescales it first
// when its total has reached limit; then cum = its exclusive cumsum,
// cum[256] = *total = its sum.
template <bool ADAPTIVE>
__device__ inline void prepare_table(uint32_t* freqs, uint32_t* cum, uint32_t* total,
                                     uint32_t limit) {
  const int lane = threadIdx.x & 31;
  uint32_t f[8], s = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    f[i] = freqs[lane * 8 + i];
    s += f[i];
  }
  uint32_t tot = __reduce_add_sync(FULL, s);
  if (ADAPTIVE && tot >= limit) {
    s = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      f[i] = (f[i] >> 1) | 1u;
      freqs[lane * 8 + i] = f[i];
      s += f[i];
    }
    tot = __reduce_add_sync(FULL, s);
  }
  uint32_t incl = s;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += y;
  }
  uint32_t run = incl - s;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    cum[lane * 8 + i] = run;
    run += f[i];
  }
  if (lane == 31) {
    cum[256] = tot;
    *total = tot;
  }
}

// Loads the initial table (CT-RC1: the given one; CT-RC2: all ones) and,
// for CT-RC1, its cum once.
template <bool ADAPTIVE>
__device__ inline void init_table(const int32_t* freqs_in, uint32_t* freqs, uint32_t* cum,
                                  uint32_t* total) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    freqs[i] = ADAPTIVE ? 1u : (uint32_t)freqs_in[i];
  __syncthreads();
  if (!ADAPTIVE && threadIdx.x < 32) prepare_table<false>(freqs, cum, total, 0);
  __syncthreads();
}

// Before a CT-RC2 step: every lane's update of the step before is in, then
// warp 0's table is out.
template <bool ADAPTIVE>
__device__ inline void step_table(uint32_t* freqs, uint32_t* cum, uint32_t* total,
                                  uint32_t limit) {
  if (!ADAPTIVE) return;
  __syncthreads();
  if (threadIdx.x < 32) prepare_table<true>(freqs, cum, total, limit);
  __syncthreads();
}

// x [stride, K] u8; lane_len [K] i32; freqs_in [256] i32 (CT-RC1) or
// null; ev [SLOTS*stride + 2, K] u32.
template <int LPT, int SLOTS, bool ADAPTIVE>
__global__ void __launch_bounds__(MAX_THREADS)
    rc_exact_encode_kernel(const uint8_t* __restrict__ x, const int32_t* __restrict__ lane_len,
                           const int32_t* __restrict__ freqs_in, uint32_t* __restrict__ ev, int K,
                           int stride, uint32_t inc, uint32_t limit) {
  __shared__ uint32_t freqs[256];
  __shared__ uint32_t cum[257];
  __shared__ uint32_t total_s;
  const int tid = threadIdx.x, bd = blockDim.x;
  uint32_t low[LPT], carry[LPT], rng[LPT], cache[LPT], csize[LPT];
  int len[LPT];
#pragma unroll
  for (int m = 0; m < LPT; ++m) {
    const int lane = tid + m * bd;
    low[m] = 0;
    carry[m] = 0;
    rng[m] = 0xFFFFFFFFu;
    cache[m] = 0;
    csize[m] = 1;
    len[m] = lane < K ? lane_len[lane] : 0;
  }
  init_table<ADAPTIVE>(freqs_in, freqs, cum, &total_s);

  for (int j = 0; j < stride; ++j) {
    step_table<ADAPTIVE>(freqs, cum, &total_s, limit);
    const uint32_t total = ADAPTIVE ? total_s : STATIC_TOTAL;
    const uint8_t* xj = x + (size_t)j * K;
    uint32_t* evj = ev + (size_t)j * SLOTS * K;
#pragma unroll
    for (int m = 0; m < LPT; ++m) {
      const int lane = tid + m * bd;
      if (lane >= K) continue;
      uint32_t e[SLOTS];
#pragma unroll
      for (int sl = 0; sl < SLOTS; ++sl) e[sl] = 0;
      if (j < len[m]) {
        const uint32_t sym = xj[lane];
        const uint32_t c = cum[sym];
        const uint32_t f = cum[sym + 1] - c;
        const uint32_t t = ADAPTIVE ? rng[m] / total : rng[m] >> 16;
        const uint32_t add = t * c;
        const uint32_t nl = low[m] + add;
        carry[m] |= nl < low[m] ? 1u : 0u;
        low[m] = nl;
        rng[m] = (c + f == total) ? rng[m] - add : t * f;
#pragma unroll
        for (int sl = 0; sl < SLOTS; ++sl) {
          if (rng[m] < RC_TOP) {
            e[sl] = shift_low(low[m], carry[m], cache[m], csize[m]);
            rng[m] <<= 8;
          }
        }
        if (ADAPTIVE) atomicAdd(&freqs[sym], inc);
      }
#pragma unroll
      for (int sl = 0; sl < SLOTS; ++sl) evj[(size_t)sl * K + lane] = e[sl];
    }
  }

  // flush: round low up to a multiple of 2^24, then shift_low twice
  uint32_t* fl0 = ev + (size_t)SLOTS * stride * K;
#pragma unroll
  for (int m = 0; m < LPT; ++m) {
    const int lane = tid + m * bd;
    if (lane >= K) continue;
    const uint32_t nl = low[m] + ((0u - low[m]) & 0xFFFFFFu);
    carry[m] |= nl < low[m] ? 1u : 0u;
    low[m] = nl;
    fl0[lane] = shift_low(low[m], carry[m], cache[m], csize[m]);
    fl0[K + lane] = shift_low(low[m], carry[m], cache[m], csize[m]);
  }
}

// words [l4, K] u32 big-endian word rows (l4 >= 1); lane_len [K] i32;
// freqs_in as for the encoder; out [K*stride] u8 (only j < lane_len is
// written).
template <int LPT, int SLOTS, bool ADAPTIVE>
__global__ void __launch_bounds__(MAX_THREADS)
    rc_exact_decode_kernel(const uint32_t* __restrict__ words, const int32_t* __restrict__ lane_len,
                           const int32_t* __restrict__ freqs_in, uint8_t* __restrict__ out, int K,
                           int l4, int stride, uint32_t inc, uint32_t limit) {
  __shared__ uint32_t freqs[256];
  __shared__ uint32_t cum[257];
  __shared__ uint32_t total_s;
  const int tid = threadIdx.x, bd = blockDim.x;
  uint32_t rng[LPT], code[LPT], occ[LPT], widx[LPT];
  uint64_t q[LPT];  // the queued bytes, the oldest highest, occ of them
  int len[LPT];
#pragma unroll
  for (int m = 0; m < LPT; ++m) {
    const int lane = tid + m * bd;
    rng[m] = 0xFFFFFFFFu;
    code[m] = lane < K ? words[lane] : 0u;
    q[m] = 0;
    occ[m] = 0;
    widx[m] = 1;
    len[m] = lane < K ? lane_len[lane] : 0;
  }
  init_table<ADAPTIVE>(freqs_in, freqs, cum, &total_s);

  for (int j = 0; j < stride; ++j) {
    step_table<ADAPTIVE>(freqs, cum, &total_s, limit);
    const uint32_t total = ADAPTIVE ? total_s : STATIC_TOTAL;
#pragma unroll
    for (int m = 0; m < LPT; ++m) {
      const int lane = tid + m * bd;
      if (lane >= K || j >= len[m]) continue;
      if (occ[m] < (uint32_t)SLOTS) {
        const uint32_t w = widx[m] < (uint32_t)l4 ? words[(size_t)widx[m] * K + lane] : 0u;
        q[m] = (q[m] << 32) | w;
        occ[m] += 4;
        ++widx[m];
      }
      const uint32_t t = ADAPTIVE ? rng[m] / total : rng[m] >> 16;
      uint32_t v = code[m] / t;
      v = v < total - 1 ? v : total - 1;
      uint32_t s = 0;
#pragma unroll
      for (uint32_t b = 128; b; b >>= 1)
        if (cum[s + b] <= v) s += b;
      const uint32_t c = cum[s];
      const uint32_t f = cum[s + 1] - c;
      code[m] -= t * c;
      rng[m] = (c + f == total) ? rng[m] - t * c : t * f;
#pragma unroll
      for (int sl = 0; sl < SLOTS; ++sl) {
        if (rng[m] < RC_TOP) {
          --occ[m];
          code[m] = (code[m] << 8) | ((uint32_t)(q[m] >> (8 * occ[m])) & 0xFFu);
          rng[m] <<= 8;
        }
      }
      if (ADAPTIVE) atomicAdd(&freqs[s], inc);
      out[(size_t)j * K + lane] = (uint8_t)s;
    }
  }
}

__host__ inline int block_threads(int k) {
  const int t = k < MAX_THREADS ? k : MAX_THREADS;
  return (t + 31) & ~31;
}

template <int LPT, int SLOTS, bool ADAPTIVE>
cudaError_t launch_encode(const void* x, const void* lane_len, const void* freqs, void* ev, int K,
                          int stride, uint32_t inc, uint32_t limit, cudaStream_t stream) {
  rc_exact_encode_kernel<LPT, SLOTS, ADAPTIVE><<<1, block_threads(K), 0, stream>>>(
      (const uint8_t*)x, (const int32_t*)lane_len, (const int32_t*)freqs, (uint32_t*)ev, K, stride,
      inc, limit);
  return cudaGetLastError();
}

template <int LPT, int SLOTS, bool ADAPTIVE>
cudaError_t launch_decode(const void* words, const void* lane_len, const void* freqs, void* out,
                          int K, int l4, int stride, uint32_t inc, uint32_t limit,
                          cudaStream_t stream) {
  rc_exact_decode_kernel<LPT, SLOTS, ADAPTIVE><<<1, block_threads(K), 0, stream>>>(
      (const uint32_t*)words, (const int32_t*)lane_len, (const int32_t*)freqs, (uint8_t*)out, K,
      l4, stride, inc, limit);
  return cudaGetLastError();
}

using EncodeFn = cudaError_t (*)(const void*, const void*, const void*, void*, int, int, uint32_t,
                                 uint32_t, cudaStream_t);
using DecodeFn = cudaError_t (*)(const void*, const void*, const void*, void*, int, int, int,
                                 uint32_t, uint32_t, cudaStream_t);

// The instantiation for K lanes (1, 2, 4 or 8 a thread), the slot count and
// the table kind; null for what none takes.
template <typename Fn, template <int, int, bool> class Pick>
Fn pick(int K, int slots, bool adaptive) {
  if (K < 1 || K > 8 * MAX_THREADS || (K & (K - 1))) return nullptr;
  const int lpt = K <= MAX_THREADS ? 1 : K / MAX_THREADS;
  const int kind = !adaptive ? (slots == 2 ? 0 : -1) : (slots == 2 ? 1 : slots == 3 ? 2 : -1);
  if (kind < 0) return nullptr;
  switch (lpt * 4 + kind) {
    case 4: return Pick<1, 2, false>::fn;
    case 5: return Pick<1, 2, true>::fn;
    case 6: return Pick<1, 3, true>::fn;
    case 8: return Pick<2, 2, false>::fn;
    case 9: return Pick<2, 2, true>::fn;
    case 10: return Pick<2, 3, true>::fn;
    case 16: return Pick<4, 2, false>::fn;
    case 17: return Pick<4, 2, true>::fn;
    case 18: return Pick<4, 3, true>::fn;
    case 32: return Pick<8, 2, false>::fn;
    case 33: return Pick<8, 2, true>::fn;
    case 34: return Pick<8, 3, true>::fn;
  }
  return nullptr;
}

template <int LPT, int SLOTS, bool ADAPTIVE>
struct PickEncode {
  static constexpr EncodeFn fn = launch_encode<LPT, SLOTS, ADAPTIVE>;
};

template <int LPT, int SLOTS, bool ADAPTIVE>
struct PickDecode {
  static constexpr DecodeFn fn = launch_decode<LPT, SLOTS, ADAPTIVE>;
};

}  // namespace

// CT-RC1 when freqs is not null (limit_log2 unused), else CT-RC2. K a power
// of two up to 8192; slots 2 (CT-RC1; CT-RC2 with limit_log2 <= 16) or 3.
// Returns the cudaError_t as an int (cudaErrorInvalidValue for what no
// instantiation takes).
extern "C" int ct_rc_exact_encode(const void* x, const void* lane_len, const void* freqs, void* ev,
                                  int K, int stride, int inc, int limit_log2, int slots,
                                  void* stream) {
  const EncodeFn fn = pick<EncodeFn, PickEncode>(K, slots, freqs == nullptr);
  if (!fn || limit_log2 < 0 || limit_log2 > 31) return (int)cudaErrorInvalidValue;
  return (int)fn(x, lane_len, freqs, ev, K, stride, (uint32_t)inc, 1u << limit_log2,
                 (cudaStream_t)stream);
}

extern "C" int ct_rc_exact_decode(const void* words, const void* lane_len, const void* freqs,
                                  void* out, int K, int l4, int stride, int inc, int limit_log2,
                                  int slots, void* stream) {
  const DecodeFn fn = pick<DecodeFn, PickDecode>(K, slots, freqs == nullptr);
  if (!fn || l4 < 1 || limit_log2 < 0 || limit_log2 > 31) return (int)cudaErrorInvalidValue;
  return (int)fn(words, lane_len, freqs, out, K, l4, stride, (uint32_t)inc, 1u << limit_log2,
                 (cudaStream_t)stream);
}
