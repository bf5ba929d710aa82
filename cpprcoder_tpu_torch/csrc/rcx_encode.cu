// Kernel A: CT-RCX encode on Hopper.
//
// Replaces the Pallas kernel cpprcoder_tpu/ops/rcx_pallas.py:163
// `_encode_kernel` (pallas_call at rcx_pallas.py:256).
//
// What it computes: for each of K chunked lanes (lane i codes bytes
// x[i*stride + j], j < lane_len[i]), an order-1 context range coder whose
// count model C[2^cbits, 256] is shared by all lanes of the stream and
// requantized every 2^wlog steps; each step emits <= 2 packed shift_low
// events per lane, and 2 flush events end each lane.
//
// Design: one CTA per stream (the model is shared by every lane, so a
// stream cannot span blocks), each thread owns ceil(K / blockDim) lanes
// whose coder state stays in registers. The model lives in shared memory,
// read by direct indexing and updated with shared-memory atomicAdd (integer
// adds commute, so the result is deterministic). Input symbols are
// time-major [stride, K] u8 and events time-major [2*stride+2, K] u32, so
// each step's loads and stores are coalesced across the warp.
//
// What bounds it: the stride steps are sequential and one stream occupies
// one SM, so a single stream is latency-bound (per step: a shared-memory
// table read, ~20 integer ops, an atomic, two coalesced stores). Many
// streams fill the card; the kernel takes a stream count for that.
#include "rcx_model.cuh"

namespace {

__device__ __forceinline__ uint32_t shift_low(uint32_t& low, uint32_t& carry, uint32_t& cache,
                                              uint32_t& csize) {
  uint32_t ev = 0;
  if (low < 0xFF000000u || carry != 0) {
    const uint32_t first = (cache + carry) & 0xFFu;
    ev = 0x80000000u | (first << 23) | ((carry & 1u) << 22) | ((csize - 1u) & ct::EV_RUN_MASK);
    cache = low >> 24;
    csize = 0;
    carry = 0;
  }
  csize += 1;
  low <<= 8;
  return ev;
}

// x [streams, stride, K] u8; lane_len [streams, K] i32;
// ev [streams, 2*stride+2, K] u32; gmodel: per-stream model scratch or null.
template <int LPT>
__global__ void __launch_bounds__(ct::MAX_THREADS) rcx_encode_kernel(const uint8_t* __restrict__ x, const int32_t* __restrict__ lane_len,
                                  uint32_t* __restrict__ ev, uint8_t* gmodel, int K, int stride,
                                  uint32_t inc, uint32_t climit, int cbits, int wlog) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int rows = 1 << cbits;
  uint32_t* C;
  uint16_t* cum;
  ct::model_ptrs(smem, gmodel, rows, &C, &cum);

  const size_t s = blockIdx.x;
  x += s * (size_t)stride * K;
  lane_len += s * K;
  ev += s * (size_t)(2 * stride + 2) * K;

  const int tid = threadIdx.x;
  const int bd = blockDim.x;
  const int shift = 8 - cbits;  // cbits = 0: prev >> 8 == 0, one context
  uint32_t low[LPT], carry[LPT], rng[LPT], cache[LPT],
      csize[LPT], prev[LPT];
  int len[LPT];
#pragma unroll
  for (int m = 0; m < LPT; ++m) {
    const int lane = tid + m * bd;
    low[m] = 0;
    carry[m] = 0;
    rng[m] = 0xFFFFFFFFu;
    cache[m] = 0;
    csize[m] = 1;
    prev[m] = 0;
    len[m] = lane < K ? lane_len[lane] : 0;
  }
  ct::model_init(C, rows);

  const int wmask = (1 << wlog) - 1;
  for (int j = 0; j < stride; ++j) {
    if ((j & wmask) == 0) {
      __syncthreads();
      ct::requant(C, cum, rows, climit);
      __syncthreads();
    }
    uint32_t* ev0 = ev + (size_t)(2 * j) * K;
    uint32_t* ev1 = ev0 + K;
    const uint8_t* xj = x + (size_t)j * K;
#pragma unroll
    for (int m = 0; m < LPT; ++m) {
      const int lane = tid + m * bd;
      if (lane < K) {
        uint32_t e0 = 0, e1 = 0;
        if (j < len[m]) {
          const uint32_t sym = xj[lane];
          const uint32_t ctx = prev[m] >> shift;
          const uint16_t* cr = cum + ctx * 257;
          const uint32_t c = cr[sym];
          const uint32_t f = cr[sym + 1] - c;
          const uint32_t t = rng[m] >> ct::QBITS;
          const uint32_t add = t * c;
          const uint32_t nl = low[m] + add;
          carry[m] |= nl < low[m] ? 1u : 0u;
          low[m] = nl;
          rng[m] = (c + f == ct::QTOTAL) ? rng[m] - add : t * f;
          if (rng[m] < ct::RC_TOP) {
            e0 = shift_low(low[m], carry[m], cache[m], csize[m]);
            rng[m] <<= 8;
          }
          if (rng[m] < ct::RC_TOP) {
            e1 = shift_low(low[m], carry[m], cache[m], csize[m]);
            rng[m] <<= 8;
          }
          atomicAdd(&C[ctx * 256 + sym], inc);
          prev[m] = sym;
        }
        ev0[lane] = e0;
        ev1[lane] = e1;
      }
    }
  }

  // flush: round low up to a multiple of 2^24, then shift_low twice
  uint32_t* fl0 = ev + (size_t)(2 * stride) * K;
  uint32_t* fl1 = fl0 + K;
#pragma unroll
  for (int m = 0; m < LPT; ++m) {
    const int lane = tid + m * bd;
    if (lane < K) {
      const uint32_t nl = low[m] + ((0u - low[m]) & 0xFFFFFFu);
      carry[m] |= nl < low[m] ? 1u : 0u;
      low[m] = nl;
      fl0[lane] = shift_low(low[m], carry[m], cache[m], csize[m]);
      fl1[lane] = shift_low(low[m], carry[m], cache[m], csize[m]);
    }
  }
}

template <int LPT>
cudaError_t launch(const void* x, const void* lane_len, void* ev, void* gmodel, int streams, int K,
                   int stride, int inc, int climit, int cbits, int wlog, cudaStream_t stream) {
  const size_t smem = ct::prepare_smem(rcx_encode_kernel<LPT>, gmodel, 1 << cbits);
  rcx_encode_kernel<LPT><<<streams, ct::block_threads(K), smem, stream>>>(
      (const uint8_t*)x, (const int32_t*)lane_len, (uint32_t*)ev, (uint8_t*)gmodel, K, stride,
      (uint32_t)inc, (uint32_t)climit, cbits, wlog);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ct_rcx_encode(const void* x, const void* lane_len, void* ev, void* gmodel,
                             int streams, int K, int stride, int inc, int climit, int cbits,
                             int wlog, void* stream) {
  cudaError_t (*fn)(const void*, const void*, void*, void*, int, int, int, int, int, int, int,
                    cudaStream_t) = nullptr;
  switch (ct::lanes_per_thread(K)) {
    case 1: fn = launch<1>; break;
    case 2: fn = launch<2>; break;
    case 4: fn = launch<4>; break;
    case 8: fn = launch<8>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)fn(x, lane_len, ev, gmodel, streams, K, stride, inc, climit, cbits, wlog,
                 (cudaStream_t)stream);
}
