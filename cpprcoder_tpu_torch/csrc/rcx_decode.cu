// Kernel C: CT-RCX decode on Hopper.
//
// Replaces the Pallas kernel cpprcoder_tpu/ops/rcx_pallas.py:374
// `_decode_kernel` (pallas_call at rcx_pallas.py:485).
//
// What it computes: the inverse of kernel A. Per lane, a 5-byte queue
// (q0, q1, occ) is topped up from the lane's big-endian u32 word row when
// fewer than 2 bytes are buffered; the symbol is the largest s with
// cum[ctx][s] * t <= code (t = range >> 15); the coder consumes it and
// renormalizes in <= 2 byte slots; the shared model takes the same +inc
// update and per-window requant as the encoder, so both sides see the
// same tables.
//
// Design: the same CTA-per-stream, registers-per-lane and shared-memory
// model as kernel A. The symbol search is an 8-step binary search over
// the context's cum row in shared memory (the row is strictly increasing
// because every q >= 1). The refill is one direct load of word `widx` from
// the word-major [l4, K] rows, coalesced across lanes that advance
// together. Each symbol goes straight to out[lane * stride + j], the
// chunked layout of the original bytes, so no transpose follows.
//
// What bounds it: like A, the steps of a stream are sequential on one SM;
// per step the search adds 8 dependent shared-memory reads.
#include "rcx_model.cuh"

namespace {

// words [streams, l4, K] u32; lane_len [streams, K] i32;
// out [streams, K * stride] u8 (only j < lane_len is written).
template <int LPT>
__global__ void __launch_bounds__(ct::MAX_THREADS) rcx_decode_kernel(const uint32_t* __restrict__ words,
                                  const int32_t* __restrict__ lane_len, uint8_t* __restrict__ out,
                                  uint8_t* gmodel, int K, int l4, int stride, uint32_t inc,
                                  uint32_t climit, int cbits, int wlog) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int rows = 1 << cbits;
  uint32_t* C;
  uint16_t* cum;
  ct::model_ptrs(smem, gmodel, rows, &C, &cum);

  const size_t s = blockIdx.x;
  words += s * (size_t)l4 * K;
  lane_len += s * K;
  out += s * (size_t)K * stride;

  const int tid = threadIdx.x;
  const int bd = blockDim.x;
  const int shift = 8 - cbits;
  uint32_t rng[LPT], code[LPT], q0[LPT], q1[LPT],
      occ[LPT], prev[LPT];
  int widx[LPT], len[LPT];
#pragma unroll
  for (int m = 0; m < LPT; ++m) {
    const int lane = tid + m * bd;
    rng[m] = 0xFFFFFFFFu;
    code[m] = (lane < K && l4 > 0) ? words[lane] : 0u;
    q0[m] = 0;
    q1[m] = 0;
    occ[m] = 0;
    widx[m] = 1;
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
#pragma unroll
    for (int m = 0; m < LPT; ++m) {
      const int lane = tid + m * bd;
      if (lane < K && j < len[m]) {
        if (occ[m] < 2u) {
          const uint32_t w = widx[m] < l4 ? words[(size_t)widx[m] * K + lane] : 0u;
          q0[m] |= occ[m] == 0u ? w : (w >> 8);
          q1[m] |= occ[m] == 0u ? 0u : (w << 24);
          occ[m] += 4u;
          widx[m] += 1;
        }
        const uint32_t ctx = prev[m] >> shift;
        const uint16_t* cr = cum + ctx * 257;
        const uint32_t t = rng[m] >> ct::QBITS;
        int lo = 0, hi = 256;  // invariant: cr[lo] * t <= code < cr[hi] * t
#pragma unroll
        for (int it = 0; it < 8; ++it) {
          const int mid = (lo + hi) >> 1;
          if ((uint32_t)cr[mid] * t <= code[m])
            lo = mid;
          else
            hi = mid;
        }
        const uint32_t sym = (uint32_t)lo;
        const uint32_t c = cr[sym];
        const uint32_t f = cr[sym + 1] - c;
        code[m] -= c * t;
        rng[m] = (c + f == ct::QTOTAL) ? rng[m] - c * t : f * t;
#pragma unroll
        for (int slot = 0; slot < 2; ++slot) {
          if (rng[m] < ct::RC_TOP) {
            const uint32_t b = q0[m] >> 24;
            q0[m] = (q0[m] << 8) | (q1[m] >> 24);
            q1[m] <<= 8;
            occ[m] -= 1u;
            code[m] = (code[m] << 8) | b;
            rng[m] <<= 8;
          }
        }
        atomicAdd(&C[ctx * 256 + sym], inc);
        prev[m] = sym;
        out[(size_t)lane * stride + j] = (uint8_t)sym;
      }
    }
  }
}

template <int LPT>
cudaError_t launch(const void* words, const void* lane_len, void* out, void* gmodel, int streams,
                   int K, int l4, int stride, int inc, int climit, int cbits, int wlog,
                   cudaStream_t stream) {
  const size_t smem = ct::prepare_smem(rcx_decode_kernel<LPT>, gmodel, 1 << cbits);
  rcx_decode_kernel<LPT><<<streams, ct::block_threads(K), smem, stream>>>(
      (const uint32_t*)words, (const int32_t*)lane_len, (uint8_t*)out, (uint8_t*)gmodel, K, l4,
      stride, (uint32_t)inc, (uint32_t)climit, cbits, wlog);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ct_rcx_decode(const void* words, const void* lane_len, void* out, void* gmodel,
                             int streams, int K, int l4, int stride, int inc, int climit,
                             int cbits, int wlog, void* stream) {
  cudaError_t (*fn)(const void*, const void*, void*, void*, int, int, int, int, int, int, int,
                    int, cudaStream_t) = nullptr;
  switch (ct::lanes_per_thread(K)) {
    case 1: fn = launch<1>; break;
    case 2: fn = launch<2>; break;
    case 4: fn = launch<4>; break;
    case 8: fn = launch<8>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)fn(words, lane_len, out, gmodel, streams, K, l4, stride, inc, climit, cbits, wlog,
                 (cudaStream_t)stream);
}
