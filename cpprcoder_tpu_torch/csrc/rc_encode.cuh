// The adaptive range-coder encode kernel shared by kernel A (CT-RCX,
// rcx_encode.cu) and kernel D (CT-RCQ, rcq_encode.cu).
//
// What it computes: for each of K lanes (lane i codes x2d[j, i] for
// j < lane_len[i]), a range coder whose count model C[2^cbits, 256] is
// shared by all lanes of the stream and requantized every 2^wlog steps
// with up to ROUNDS halvings; each step emits <= 2 packed shift_low events
// per lane, and 2 flush events end each lane. The lane layout (chunked for
// CT-RCX, interleaved for CT-RCQ) is the caller's: the kernel only sees
// the [stride, K] grid and the lane lengths.
//
// Design: one CTA per stream (the model is shared by every lane, so a
// stream cannot span blocks), each thread owns ceil(K / blockDim) lanes
// whose coder state stays in registers. The model lives in shared memory,
// read by direct indexing and updated with shared-memory atomicAdd (integer
// adds commute, so the result is deterministic). Input symbols are
// time-major [stride, K] u8 and events time-major [2*stride+2, K] u32, so
// each step's loads and stores are coalesced across the warp.
//
// ONE_ROW (kernel D: one row, requantized before every step) is its own
// instantiation, which knows that at compile time and shortens the step:
//   - the row is requantized by 8 warps, one cell a thread
//     (ct::requant_cells, kernel E's code, storing the cum row sorted), in
//     a block of at least 256 threads;
//   - each lane's next symbol is loaded during the step before, so the
//     load's latency overlaps the barriers and the requant (below 8 lanes
//     a thread: at 8 the registers it takes would spill);
//   - the lanes add to two sub-histograms, even and odd threads apart, so
//     that a warp's lanes on one symbol (runs) conflict on half as many
//     atomics; the requant threads fold them into the counts;
//   - the model is addressed as shared memory, and without stream offsets
//     (a launch is always one stream).
//
// What bounds it: the stride steps are sequential and one stream occupies
// one SM, so a single stream is latency-bound (per step: a shared-memory
// table read, ~20 integer ops, an atomic, two coalesced stores; plus the
// requant between two barriers at each window start, every step for
// kernel D). Many streams fill the card; the kernel takes a stream count
// for that.
#pragma once

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

// A lane's csize packed with its cache (bits 22-29) and carry (bit 30):
// the three fields.
__device__ __forceinline__ void unpack_lane(uint32_t& csize, uint32_t& cache, uint32_t& carry) {
  carry = csize >> 30;
  cache = (csize >> 22) & 0xFFu;
  csize &= 0x3FFFFFu;
}

// ONE_ROW: the lanes' updates of a step go to SUBS sub-histograms, lane
// (thread) t to copy t % SUBS, SUB_STRIDE words apart so that one symbol's
// copies sit on different banks.
constexpr int SUBS = 2, SUB_STRIDE = 257;

// x [streams, stride, K] u8; lane_len [streams, K] i32;
// ev [streams, 2*stride+2, K] u32; gmodel: per-stream model scratch or null.
// ONE_ROW launches pass cbits = wlog = 0, and ask for one block an SM, so
// that ptxas may give a thread its 64 registers (at one lane a thread it
// otherwise stops at 32 and spills); a minimum of 0 is none, so kernel A
// compiles as with no minimum.
template <int LPT, int ROUNDS, bool ONE_ROW>
__global__ void __launch_bounds__(ct::MAX_THREADS, ONE_ROW ? 1 : 0) rc_encode_kernel(const uint8_t* __restrict__ x, const int32_t* __restrict__ lane_len,
                                  uint32_t* __restrict__ ev, uint8_t* gmodel, int K, int stride,
                                  uint32_t inc, uint32_t climit, int cbits, int wlog) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint32_t xch[ONE_ROW ? ROUNDS + 4 : 1][8];
  __shared__ uint32_t sub[ONE_ROW ? SUBS * SUB_STRIDE : 1];
  const int rows = ONE_ROW ? 1 : 1 << cbits;
  uint32_t* C;
  uint16_t* cum;
  // ONE_ROW's model is always in shared memory, addressed as such
  ct::model_ptrs(smem, ONE_ROW ? nullptr : gmodel, rows, &C, &cum);

  const size_t s = ONE_ROW ? 0 : blockIdx.x;  // ONE_ROW: one stream
  x += s * (size_t)stride * K;
  lane_len += s * K;
  ev += s * (size_t)(2 * stride + 2) * K;

  const int tid = threadIdx.x;
  const int bd = blockDim.x;
  const int shift = 8 - cbits;  // cbits = 0: prev >> 8 == 0, one context
  uint32_t low[LPT], carry[LPT], rng[LPT], cache[LPT],
      csize[LPT], prev[LPT];
  // ONE_ROW below 8 lanes a thread: each lane's symbol of the next step
  // (at 8 the registers it takes would spill)
  constexpr bool AHEAD = ONE_ROW && LPT < 8;
  // ONE_ROW at 8 lanes a thread keeps each lane's cache and carry in the
  // top bits of its csize between steps (csize stays below 2^22, as the
  // event's run field: the wrappers check 3 * stride + 2 < 2^22), so that
  // its lane state fits the 64 registers of a 1024-thread block
  constexpr bool PACK = ONE_ROW && LPT == 8;
  uint32_t nsym[LPT];
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
    if constexpr (AHEAD) nsym[m] = len[m] > 0 ? x[lane] : 0u;
  }
  ct::model_init(C, rows);
  if constexpr (ONE_ROW)
    for (int i = tid; i < SUBS * SUB_STRIDE; i += bd) sub[i] = 0;
  uint32_t* mysub = sub + (tid % SUBS) * SUB_STRIDE;

  const int wmask = (1 << wlog) - 1;
  for (int j = 0; j < stride; ++j) {
    if constexpr (ONE_ROW) {
      __syncthreads();
      if (tid < ct::CELL_THREADS) {
        // the step's updates folded into the count (integer adds commute:
        // the same count as one histogram), the sub-histograms emptied
        uint32_t c = C[tid];
#pragma unroll
        for (int g = 0; g < SUBS; ++g) {
          c += sub[g * SUB_STRIDE + tid];
          sub[g * SUB_STRIDE + tid] = 0;
        }
        C[tid] = c;
        ct::requant_cells<ROUNDS, false>(C, cum, climit, xch);
      }
      __syncthreads();
    } else if ((j & wmask) == 0) {
      __syncthreads();
      ct::requant<ROUNDS>(C, cum, rows, climit);
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
          if constexpr (PACK) unpack_lane(csize[m], cache[m], carry[m]);
          uint32_t sym;
          if constexpr (AHEAD) {
            sym = nsym[m];
            if (j + 1 < len[m]) nsym[m] = xj[K + lane];
          } else {
            sym = xj[lane];
          }
          const uint32_t ctx = ONE_ROW ? 0u : prev[m] >> shift;
          const uint16_t* cr = cum + ctx * ct::CUM_STRIDE;
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
          if constexpr (PACK) csize[m] |= (cache[m] << 22) | (carry[m] << 30);
          if constexpr (ONE_ROW) {
            atomicAdd(&mysub[sym], inc);
          } else {
            atomicAdd(&C[ctx * 256 + sym], inc);
            prev[m] = sym;
          }
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
      if constexpr (PACK) unpack_lane(csize[m], cache[m], carry[m]);
      const uint32_t nl = low[m] + ((0u - low[m]) & 0xFFFFFFu);
      carry[m] |= nl < low[m] ? 1u : 0u;
      low[m] = nl;
      fl0[lane] = shift_low(low[m], carry[m], cache[m], csize[m]);
      fl1[lane] = shift_low(low[m], carry[m], cache[m], csize[m]);
    }
  }
}

template <int LPT, int ROUNDS, bool ONE_ROW>
cudaError_t launch_encode(const void* x, const void* lane_len, void* ev, void* gmodel, int streams,
                          int K, int stride, int inc, int climit, int cbits, int wlog,
                          cudaStream_t stream) {
  const size_t smem = gmodel ? 0 : ct::model_bytes(1 << cbits);
  const cudaError_t err = ct::prepare_smem(rc_encode_kernel<LPT, ROUNDS, ONE_ROW>, smem);
  if (err != cudaSuccess) return err;
  const int threads = ONE_ROW ? ct::coder_threads(K, 1, true) : ct::block_threads(K);
  rc_encode_kernel<LPT, ROUNDS, ONE_ROW><<<streams, threads, smem, stream>>>(
      (const uint8_t*)x, (const int32_t*)lane_len, (uint32_t*)ev, (uint8_t*)gmodel, K, stride,
      (uint32_t)inc, (uint32_t)climit, cbits, wlog);
  return cudaGetLastError();
}

// Picks the lanes-per-thread instantiation for K; returns the launch's
// cudaError_t as an int (cudaErrorInvalidValue when K is too large).
template <int ROUNDS, bool ONE_ROW>
int rc_encode(const void* x, const void* lane_len, void* ev, void* gmodel, int streams, int K,
              int stride, int inc, int climit, int cbits, int wlog, void* stream) {
  cudaError_t (*fn)(const void*, const void*, void*, void*, int, int, int, int, int, int, int,
                    cudaStream_t) = nullptr;
  switch (ct::lanes_per_thread(K)) {
    case 1: fn = launch_encode<1, ROUNDS, ONE_ROW>; break;
    case 2: fn = launch_encode<2, ROUNDS, ONE_ROW>; break;
    case 4: fn = launch_encode<4, ROUNDS, ONE_ROW>; break;
    case 8: fn = launch_encode<8, ROUNDS, ONE_ROW>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)fn(x, lane_len, ev, gmodel, streams, K, stride, inc, climit, cbits, wlog,
                 (cudaStream_t)stream);
}

}  // namespace
