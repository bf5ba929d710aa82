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
// Design: the model is shared by every lane of a stream, so a stream is
// one CTA, or for CT-RCX from ct::CLUSTER_MIN_K lanes on one cluster of G
// CTAs; each thread owns up to LPT lanes whose coder state stays in
// registers. The model lives in shared memory, read by direct indexing and
// updated with shared-memory atomicAdd (integer adds commute, so the
// result is deterministic). Input symbols are time-major [stride, K] u8
// and events time-major [2*stride+2, K] u32, so each step's loads and
// stores are coalesced across the warp. Each lane loads its next symbol
// during the step before, so that the load's latency overlaps the step and
// the barriers.
//
// CT-RCX (kernel A) shares kernel C's model handling (rc_decode.cuh), so
// that a window costs what the rows that changed cost:
//   - a block has at least a warp a model row (ct::coder_threads), and a
//     window requantizes only the rows whose total moved since their last
//     requant left it below climit (ct::requant_changed; at small K the
//     one warp of lanes touches a few of the 2^cbits rows in a window);
//   - in a cluster each CTA codes a quarter of the lanes against its own
//     copy of every cum row and holds the counts of a quarter of the rows;
//     updates to another CTA's rows are atomics through distributed shared
//     memory, and the owners requantize and copy out the changed rows
//     between two cluster barriers (ct::requant_owned). That splits the
//     lanes' shared-memory traffic over 4 SMs, and it lets 32,768 lanes run
//     (4 x 1024 threads x 8 lanes) and cbits = 8 fit shared memory; a lone
//     CTA at cbits = 8 keeps its model in global scratch (GMODEL);
//   - a lone CTA's lanes also mark each row they add to (touched[r]), so
//     that the requant passes over an unmarked row whose last requant left
//     it below climit without reading its counts;
//   - a lane's previous symbol rides in the register of its next one (from
//     8 lanes a thread, with no look-ahead, in the top byte of its length).
//
// ONE_ROW (kernel D: one row, requantized before every step) is its own
// instantiation, which knows that at compile time and shortens the step:
//   - the row is requantized by 8 warps, one cell a thread
//     (ct::requant_cells, kernel E's code, storing the cum row sorted), in
//     a block of at least 256 threads;
//   - the lanes add to two sub-histograms, even and odd threads apart, so
//     that a warp's lanes on one symbol (runs) conflict on half as many
//     atomics; the requant threads fold them into the counts;
//   - no stream offsets (a launch is always one stream).
// From 8 lanes a thread each lane's cache and carry ride in the top bits of
// its csize between steps (PACK), and the look-ahead stops.
//
// RESUME (kernel O, ONE_ROW only) runs a chunk of a stream's steps from a
// saved state: each lane's five state words and the model's counts are
// loaded at the start (the lane's cache and carry packed into its csize
// there under PACK) and stored at the end, unpacked; the counts stored are
// the last step's updates folded into its requantized counts, with no
// requant after them, so that the next chunk's first step requantizes them
// as the one-shot kernel's next step would. A lane codes row j of the
// chunk iff t0 + j < lane_len (its length in the whole stream), clamped to
// the chunk's rows, so the look-ahead load stops at the last row. The
// flush runs only where asked, after the state is stored.
//
// RANGE (the lane-range form of A and D, for a stream whose lanes are
// sharded over several ranks, parallel/sharded_rcx.py and sharded_rcq.py):
// every lane of the stream runs the model's update from its own symbols,
// exactly as in the one-shot form, but only lanes l0 .. l0 + ko - 1 run the
// coder and write events, into [2*stride+2, ko] (lane l0 + i to column i).
// The other lanes read their symbols and add to the counts, nothing more.
// The model never leaves the kernel, so every rank's model is the one-shot
// kernel's, step for step, and its lanes' events are the one-shot events'
// columns l0 .. l0 + ko - 1.
//
// What bounds it: the stride steps are sequential and one stream occupies
// one SM (a cluster: four), so a single stream is latency-bound (per step:
// a shared-memory table read, ~20 integer ops, an atomic, two coalesced
// stores; plus the requant between two barriers at each window start,
// every step for kernel D). Many streams fill the card; the kernel takes a
// stream count for that.
#pragma once

#include "rcx_model.cuh"

namespace {

namespace cg = cooperative_groups;

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

// Kernel O's state in and out: st [5, K] u32 (low, carry, range, cache,
// cache_size) and the counts C[256]; t0, the stream step of the chunk's
// first row; flush, whether the two flush rows follow the steps. The
// one-shot instantiations take none of it.
struct Resume {
  const uint32_t* st_in;
  uint32_t* st_out;
  const uint32_t* c_in;
  uint32_t* c_out;
  int t0;
  int flush;
};

// x [streams, stride, K] u8; lane_len [streams, K] i32;
// ev [streams, 2*stride+2, K] u32; gmodel: per-stream model scratch (the
// GMODEL instantiation) or null. G > 1: stream s is the cluster of blocks
// s*G .. s*G + G-1, block g of it coding lanes g*ceil(K/G) .. and holding
// the counts of the rows it owns and a copy of every cum row. ONE_ROW
// launches pass cbits = wlog = 0, and ask for one block an SM, so that
// ptxas may give a thread its 64 registers (at one lane a thread it
// otherwise stops at 32 and spills); a minimum of 0 is none, so kernel A
// compiles as with no minimum.
// RANGE: events only for lanes l0 .. l0 + ko - 1, into [.., ko] (above).
template <int LPT, int ROUNDS, bool ONE_ROW, int G, bool GMODEL, bool RESUME = false,
          bool RANGE = false>
__global__ void __launch_bounds__(ct::MAX_THREADS, ONE_ROW ? 1 : 0) rc_encode_kernel(const uint8_t* __restrict__ x, const int32_t* __restrict__ lane_len,
                                  uint32_t* __restrict__ ev, uint8_t* gmodel, int K, int stride,
                                  uint32_t inc, uint32_t climit, int cbits, int wlog,
                                  Resume rs, int l0, int ko) {
  static_assert(!RESUME || (ONE_ROW && G == 1 && !GMODEL), "kernel O is D's one-row kernel");
  static_assert(!(RESUME && RANGE), "kernel O codes every lane");
  // the lanes that code and their events' row width
  const int lo = RANGE ? l0 : 0, kout = RANGE ? ko : K;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint32_t xch[ONE_ROW ? ROUNDS + 4 : 1][8];
  __shared__ uint32_t sub[ONE_ROW ? SUBS * SUB_STRIDE : 1];
  __shared__ uint32_t last[ONE_ROW ? 1 : 256];
  __shared__ uint8_t touched[ONE_ROW || G > 1 ? 1 : 256];
  const int rows = ONE_ROW ? 1 : 1 << cbits;
  const size_t s = ONE_ROW ? 0 : blockIdx.x / G;  // ONE_ROW: one stream
  const int g = ONE_ROW ? 0 : (int)(blockIdx.x % G);
  const int kg = (K + G - 1) / G;        // lanes of a block
  const int held = (rows + G - 1) / G;  // count rows of a block
  uint8_t* base = GMODEL ? gmodel + s * ct::model_bytes(rows) : smem;
  uint32_t* C = reinterpret_cast<uint32_t*>(base);
  uint16_t* cum = reinterpret_cast<uint16_t*>(base + (size_t)held * 256 * 4);
  x += s * (size_t)stride * K;
  lane_len += s * K;
  ev += s * (size_t)(2 * stride + (RESUME ? 2 * rs.flush : 2)) * kout;

  const int tid = threadIdx.x;
  const int bd = blockDim.x;
  const int shift = 8 - cbits;  // cbits = 0: prev >> 8 == 0, one context
  // CT-RCX: nsym holds the lane's next symbol (bits 0-7) above its previous
  // one (8-15), whose top cbits bits are the context: nsym >> pshift
  const int pshift = 16 - cbits;
  uint32_t low[LPT], carry[LPT], rng[LPT], cache[LPT], csize[LPT];
  // each lane's symbol of the next step, below 8 lanes a thread (at 8 the
  // registers it takes would spill)
  constexpr bool AHEAD = LPT < 8;
  // from 8 lanes a thread each lane's cache and carry sit in the top bits
  // of its csize between steps (csize stays below 2^22, as the event's run
  // field: the wrappers check 3 * stride + 2 < 2^22), and CT-RCX's previous
  // symbol in the top byte of its length (< 2^22 as well), so that its lane
  // state fits the 64 registers of a 1024-thread block
  constexpr bool PACK = LPT >= 8;
  constexpr bool PREV_IN_LEN = PACK && !ONE_ROW;
  uint32_t nsym[LPT];
  int len[LPT];
#pragma unroll
  for (int m = 0; m < LPT; ++m) {
    const int loc = tid + m * bd, lane = g * kg + loc;
    const bool mine = loc < kg && lane < K;
    if constexpr (RESUME) {
      low[m] = mine ? rs.st_in[lane] : 0u;
      carry[m] = mine ? rs.st_in[K + lane] : 0u;
      rng[m] = mine ? rs.st_in[2 * K + lane] : 0u;
      cache[m] = mine ? rs.st_in[3 * K + lane] : 0u;
      csize[m] = mine ? rs.st_in[4 * K + lane] : 0u;
      if constexpr (PACK) csize[m] |= (cache[m] << 22) | (carry[m] << 30);
      const int left = mine ? lane_len[lane] - rs.t0 : 0;
      len[m] = left < 0 ? 0 : (left < stride ? left : stride);
    } else {
      low[m] = 0;
      carry[m] = 0;
      rng[m] = 0xFFFFFFFFu;
      cache[m] = 0;
      csize[m] = 1;
      len[m] = mine ? lane_len[lane] : 0;
    }
    if constexpr (AHEAD) nsym[m] = len[m] > 0 ? x[lane] : 0u;  // previous symbol 0
  }
  if constexpr (RESUME) {
    for (int i = tid; i < 256; i += bd) C[i] = rs.c_in[i];
  } else {
    ct::model_init(C, held);
  }
  if constexpr (ONE_ROW)
    for (int i = tid; i < SUBS * SUB_STRIDE; i += bd) sub[i] = 0;
  else
    for (int r = tid; r < rows; r += bd) {
      last[r] = 0;
      if constexpr (G == 1) touched[r] = 0;
    }
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
        for (int h = 0; h < SUBS; ++h) {
          c += sub[h * SUB_STRIDE + tid];
          sub[h * SUB_STRIDE + tid] = 0;
        }
        C[tid] = c;
        ct::requant_cells<ROUNDS, false>(C, cum, climit, xch);
      }
      __syncthreads();
    } else if ((j & wmask) == 0) {
      if constexpr (G > 1) {
        // every block's updates in, then every owner's rows out
        cg::this_cluster().sync();
        ct::requant_owned<ROUNDS, G>(C, cum, last, rows, climit, g);
        cg::this_cluster().sync();
      } else {
        __syncthreads();
        ct::requant_changed<ROUNDS, true>(C, cum, last, rows, climit, touched);
        __syncthreads();
      }
    }
    uint32_t* ev0 = ev + (size_t)(2 * j) * kout;
    uint32_t* ev1 = ev0 + kout;
    const uint8_t* xj = x + (size_t)j * K;
#pragma unroll
    for (int m = 0; m < LPT; ++m) {
      const int loc = tid + m * bd, lane = g * kg + loc;
      if (loc < kg && lane < K) {
        uint32_t e0 = 0, e1 = 0;
        if (j < (PREV_IN_LEN ? len[m] & 0xFFFFFF : len[m])) {
          if constexpr (PACK) unpack_lane(csize[m], cache[m], carry[m]);
          uint32_t sym, ctx = 0;
          if constexpr (PREV_IN_LEN) {
            sym = xj[lane];
            ctx = ((uint32_t)len[m] >> 24) >> shift;
            len[m] = (len[m] & 0xFFFFFF) | (int)(sym << 24);
          } else if constexpr (!ONE_ROW) {
            sym = nsym[m] & 0xFFu;
            ctx = nsym[m] >> pshift;
            nsym[m] = (j + 1 < len[m] ? (uint32_t)xj[K + lane] : 0u) | (sym << 8);
          } else if constexpr (AHEAD) {
            sym = nsym[m];
            if (j + 1 < len[m]) nsym[m] = xj[K + lane];
          } else {
            sym = xj[lane];
          }
          if (!RANGE || (unsigned)(lane - lo) < (unsigned)kout) {
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
          }
          if constexpr (PACK) csize[m] |= (cache[m] << 22) | (carry[m] << 30);
          if constexpr (ONE_ROW) {
            atomicAdd(&mysub[sym], inc);
          } else if constexpr (G > 1) {
            // to the owner's counts: this block's, or another's through
            // distributed shared memory
            uint32_t* cell = &C[(ctx / G) * 256 + sym];
            const unsigned owner = ctx % G;
            if (owner != (unsigned)g) cell = cg::this_cluster().map_shared_rank(cell, owner);
            atomicAdd(cell, inc);
          } else {
            atomicAdd(&C[ctx * 256 + sym], inc);
            touched[ctx] = 1;
          }
        }
        if (!RANGE || (unsigned)(lane - lo) < (unsigned)kout) {
          ev0[lane - lo] = e0;
          ev1[lane - lo] = e1;
        }
      }
    }
  }

  if constexpr (RESUME) {
    // the counts after the last step: its updates folded in, no requant
    __syncthreads();
    if (tid < ct::CELL_THREADS) {
      uint32_t c = C[tid];
#pragma unroll
      for (int h = 0; h < SUBS; ++h) c += sub[h * SUB_STRIDE + tid];
      rs.c_out[tid] = c;
    }
  }

  // flush: round low up to a multiple of 2^24, then shift_low twice
  uint32_t* fl0 = ev + (size_t)(2 * stride) * kout;
  uint32_t* fl1 = fl0 + kout;
#pragma unroll
  for (int m = 0; m < LPT; ++m) {
    const int loc = tid + m * bd, lane = g * kg + loc;
    if (loc < kg && lane < K && (!RANGE || (unsigned)(lane - lo) < (unsigned)kout)) {
      if constexpr (PACK) unpack_lane(csize[m], cache[m], carry[m]);
      if constexpr (RESUME) {
        rs.st_out[lane] = low[m];
        rs.st_out[K + lane] = carry[m];
        rs.st_out[2 * K + lane] = rng[m];
        rs.st_out[3 * K + lane] = cache[m];
        rs.st_out[4 * K + lane] = csize[m];
        if (!rs.flush) continue;
      }
      const uint32_t nl = low[m] + ((0u - low[m]) & 0xFFFFFFu);
      carry[m] |= nl < low[m] ? 1u : 0u;
      low[m] = nl;
      fl0[lane - lo] = shift_low(low[m], carry[m], cache[m], csize[m]);
      fl1[lane - lo] = shift_low(low[m], carry[m], cache[m], csize[m]);
    }
  }
  // no block leaves while the others may still add to its counts
  if constexpr (G > 1) cg::this_cluster().sync();
}

// Launches one instantiation: streams * G blocks, a cluster of G a stream;
// returns its cudaError_t. RANGE launches pass the lanes that code, l0 ..
// l0 + ko - 1; the others pass l0 = 0, ko = K.
template <int LPT, int ROUNDS, bool ONE_ROW, int G, bool GMODEL, bool RESUME, bool RANGE>
cudaError_t launch_encode_any(const void* x, const void* lane_len, void* ev, void* gmodel,
                              int streams, int K, int stride, int inc, uint32_t climit, int cbits,
                              int wlog, Resume rs, int l0, int ko, cudaStream_t stream) {
  const int rows = 1 << cbits, held = (rows + G - 1) / G;
  const size_t smem = GMODEL ? 0 : ct::model_bytes(rows) - (size_t)(rows - held) * 256 * 4;
  const int threads = ct::coder_threads((K + G - 1) / G, held, ONE_ROW);
  return ct::launch_streams<G>(
      rc_encode_kernel<LPT, ROUNDS, ONE_ROW, G, GMODEL, RESUME, RANGE>, streams, threads, smem,
      stream, (const uint8_t*)x, (const int32_t*)lane_len, (uint32_t*)ev, (uint8_t*)gmodel, K,
      stride, (uint32_t)inc, climit, cbits, wlog, rs, l0, ko);
}

template <int LPT, int ROUNDS, bool ONE_ROW, int G, bool GMODEL, bool RESUME = false>
cudaError_t launch_encode_resume(const void* x, const void* lane_len, void* ev, void* gmodel,
                                 int streams, int K, int stride, int inc, uint32_t climit,
                                 int cbits, int wlog, Resume rs, cudaStream_t stream) {
  return launch_encode_any<LPT, ROUNDS, ONE_ROW, G, GMODEL, RESUME, false>(
      x, lane_len, ev, gmodel, streams, K, stride, inc, climit, cbits, wlog, rs, 0, K, stream);
}

template <int LPT, int ROUNDS, bool ONE_ROW, int G, bool GMODEL>
cudaError_t launch_encode(const void* x, const void* lane_len, void* ev, void* gmodel, int streams,
                          int K, int stride, int inc, uint32_t climit, int cbits, int wlog,
                          cudaStream_t stream) {
  return launch_encode_resume<LPT, ROUNDS, ONE_ROW, G, GMODEL>(
      x, lane_len, ev, gmodel, streams, K, stride, inc, climit, cbits, wlog, Resume{}, stream);
}

template <int LPT, int ROUNDS, bool ONE_ROW, int G, bool GMODEL>
cudaError_t launch_encode_range(const void* x, const void* lane_len, void* ev, void* gmodel,
                                int streams, int K, int stride, int inc, uint32_t climit,
                                int cbits, int wlog, int l0, int ko, cudaStream_t stream) {
  return launch_encode_any<LPT, ROUNDS, ONE_ROW, G, GMODEL, false, true>(
      x, lane_len, ev, gmodel, streams, K, stride, inc, climit, cbits, wlog, Resume{}, l0, ko,
      stream);
}

using EncodeFn = cudaError_t (*)(const void*, const void*, void*, void*, int, int, int, int,
                                 uint32_t, int, int, cudaStream_t);
using RangeFn = cudaError_t (*)(const void*, const void*, void*, void*, int, int, int, int,
                                uint32_t, int, int, int, int, cudaStream_t);
using ResumeFn = cudaError_t (*)(const void*, const void*, void*, void*, int, int, int, int,
                                 uint32_t, int, int, Resume, cudaStream_t);

}  // namespace
