// The adaptive range-coder decode kernel shared by kernel C (CT-RCX,
// rcx_decode.cu) and kernel E (CT-RCQ, rcq_decode.cu): the inverse of
// rc_encode.cuh.
//
// What it computes: per lane, a 5-byte queue (q0, q1, occ) is topped up
// from the lane's big-endian u32 word row when fewer than 2 bytes are
// buffered; the symbol is the largest s with cum[ctx][s] * t <= code
// (t = range >> 15); the coder consumes it and renormalizes in <= 2 byte
// slots; the shared model takes the same +inc update and per-window
// requant (up to ROUNDS halvings) as the encoder, so both sides see the
// same tables. Lane i's step-j symbol goes to out[i * stride + j] for
// chunked lanes (CT-RCX) and to out[j * K + i] for INTERLEAVED ones
// (CT-RCQ): the original byte order either way, so no transpose follows.
//
// Design: the lanes of a stream share its model, so a stream is one CTA
// (CT-RCQ; CT-RCX below 1024 lanes) or one cluster of G CTAs (CT-RCX from
// 1024 lanes on, rcx_decode.cu). Lane state is in registers, the model in
// shared memory, addressed as such (GMODEL, the global scratch of a lone
// CTA at cbits = 8, is its own instantiation). A step is a chain per lane,
// and a window's requant sits between two barriers, so the design shortens
// both:
//   - the requant (ct::requant_row) divides through an fp64 reciprocal with
//     one exact correction, reduces with single-instruction warp reductions
//     and reads the counts as 16-byte vectors;
//   - a row that has not changed is not requantized: its total is the one
//     its last requant left (counts only grow), and when that requant left
//     it below climit, a new one would give the same C and cum. last[r]
//     holds that total, or 0 (no total) when the row must be redone. Row r
//     belongs to warp r mod (warps), and the block has at least a warp a
//     row (up to 1024 threads), so at small K a window costs about one
//     row's requant, not 2^cbits of them;
//   - a single row (CT-RCQ's, every step) is requantized by 8 warps, one
//     cell a thread, exchanging the totals, the first argmax and the scan
//     through shared memory (ct::requant_cells, which kernel D shares),
//     and kept in the search's tree order (ct::tree_node), where all lanes
//     read one row and each level's nodes share a bank word; CT-RCX's rows
//     stay sorted, as the encoders keep them;
//   - in a cluster each CTA runs a quarter of the lanes against its own
//     copy of every cum row, and owns a quarter of the rows: their counts
//     sit in its shared memory, every CTA's updates to them arrive as
//     atomics through distributed shared memory, and at each window the
//     owner requantizes the changed ones and writes their cum rows into
//     every copy, between two cluster barriers. That splits the lanes'
//     shared-memory traffic, which sets a step's pace at large K, over 4
//     SMs;
//   - the next word of each lane is loaded as soon as the current one is
//     taken, a step or more before a refill needs it (up to 4 lanes a
//     thread: at 8 the register it takes would spill).
// Lane state: pk holds prev (bits 0-7) and occ (8-10). At one lane a
// thread q1's byte tops pk (24-31), x1 is the lane length and wx the next
// word index. From 2 lanes a thread (a block of more than 1024 lanes), so
// that 8 fit 64 registers, pk holds the word index instead (11-31) and x1
// the length (0-23) under q1's byte. A lane takes a word at most every
// other step, so its word index stays below stride / 2 + 4: exact for
// stride <= PACKED_MAX_STRIDE, which every container meets there (n <
// 2^32 bytes over more than 1024 lanes).
//
// What bounds it: a stream's steps are sequential. At large K a step is the
// lanes' search reads and atomics through each SM's shared-memory pipe,
// plus, once a window, two barriers (cluster barriers for CT-RCX) around
// the requant; at small K it is one lane chain's latency plus, once a
// window, the requant of the changed rows between two barriers.
#pragma once

#include "rcx_model.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr uint32_t OCC_MASK = 0x700u, OCC_ONE = 0x100u, WIDX_ONE = 0x800u;
constexpr uint32_t LOW24 = 0xFFFFFFu;
constexpr int PACKED_MAX_STRIDE = (1 << 22) - 8;  // packed lane state, LPT >= 2

// words [streams, l4, K] u32; lane_len [streams, K] i32;
// out [streams, K * stride] u8 (only j < lane_len is written).
// G > 1: stream s is the cluster of blocks s*G .. s*G + G-1, block g of it
// taking lanes g*ceil(K/G) .. and holding the counts of the rows it owns
// (requant_owned) and a copy of every cum row, all in shared memory.
// INTERLEAVED (CT-RCQ) launches pass cbits = wlog = 0: one row,
// requantized before every step, which the kernel then knows at compile
// time.
template <int LPT, int ROUNDS, bool INTERLEAVED, bool GMODEL, int G>
__global__ void __launch_bounds__(ct::MAX_THREADS)
    rc_decode_kernel(const uint32_t* __restrict__ words, const int32_t* __restrict__ lane_len,
                     uint8_t* __restrict__ out, uint8_t* gmodel, int K, int l4, int stride,
                     uint32_t inc, uint32_t climit, int cbits, int wlog) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint32_t last[256];
  __shared__ uint32_t xch[ROUNDS + 4][8];
  const int rows = INTERLEAVED ? 1 : 1 << cbits;
  const int shift = INTERLEAVED ? 8 : 8 - cbits;
  const int wmask = INTERLEAVED ? 0 : (1 << wlog) - 1;
  const size_t s = blockIdx.x / G;
  const int g = (int)(blockIdx.x % G);
  const int kg = (K + G - 1) / G;        // lanes of a block
  const int held = (rows + G - 1) / G;  // count rows of a block
  uint8_t* base = GMODEL ? gmodel + s * ct::model_bytes(rows) : smem;
  uint32_t* C = reinterpret_cast<uint32_t*>(base);
  uint16_t* cum = reinterpret_cast<uint16_t*>(base + (size_t)held * 256 * 4);
  words += s * (size_t)l4 * K;
  lane_len += s * K;
  out += s * (size_t)K * stride;

  const int tid = threadIdx.x;
  const int bd = blockDim.x;
  // the look-ahead word costs a register a lane, one too many for 8 lanes
  // a thread in 64 registers (ptxas spills there)
  constexpr bool AHEAD = LPT < 8;
  constexpr bool PACKED = LPT >= 2;
  uint32_t rng[LPT], code[LPT], q0[LPT], x1[LPT], nxt[LPT], pk[LPT], wx[LPT];
#pragma unroll
  for (int m = 0; m < LPT; ++m) {
    const int loc = tid + m * bd, lane = g * kg + loc;
    const bool ok = loc < kg && lane < K;
    const int len = ok ? lane_len[lane] : 0;  // 0: not a lane
    rng[m] = 0xFFFFFFFFu;
    code[m] = (ok && l4 > 0) ? words[lane] : 0u;
    nxt[m] = (AHEAD && ok && l4 > 1) ? words[K + lane] : 0u;
    q0[m] = 0;
    x1[m] = len < 0 ? 0u : (uint32_t)(len < stride ? len : stride);
    wx[m] = 2;                               // the next word
    pk[m] = PACKED ? 2 * WIDX_ONE : 0u;      // prev 0, occ 0
  }
  ct::model_init(C, held);
  for (int r = tid; r < rows; r += bd) last[r] = 0;

  for (int j = 0; j < stride; ++j) {
    if ((j & wmask) == 0) {
      if constexpr (G > 1) {
        // every block's updates in, then every owner's rows out
        cg::this_cluster().sync();
        ct::requant_owned<ROUNDS, G>(C, cum, last, rows, climit, g);
        cg::this_cluster().sync();
      } else {
        __syncthreads();
        if (INTERLEAVED) {
          if (tid < ct::CELL_THREADS) ct::requant_cells<ROUNDS, true>(C, cum, climit, xch);
        } else {
          ct::requant_changed<ROUNDS>(C, cum, last, rows, climit);
        }
        __syncthreads();
      }
    }
#pragma unroll
    for (int m = 0; m < LPT; ++m) {
      if ((uint32_t)j >= (PACKED ? x1[m] & LOW24 : x1[m])) continue;
      const int lane = g * kg + tid + m * bd;
      uint32_t p = pk[m];
      uint32_t& q1 = PACKED ? x1[m] : p;  // q1's byte is bits 24-31 of this
      if ((p & OCC_MASK) < 2 * OCC_ONE) {
        const uint32_t wi = PACKED ? p >> 11 : wx[m];  // the word after the one taken now
        const uint32_t wd =
            AHEAD ? nxt[m] : (wi - 1 < (uint32_t)l4 ? words[(size_t)(wi - 1) * K + lane] : 0u);
        const bool empty = (p & OCC_MASK) == 0;
        q0[m] |= empty ? wd : (wd >> 8);
        q1 |= empty ? 0u : (wd << 24);
        if constexpr (AHEAD) nxt[m] = wi < (uint32_t)l4 ? words[(size_t)wi * K + lane] : 0u;
        p += 4 * OCC_ONE + (PACKED ? WIDX_ONE : 0u);
        if constexpr (!PACKED) ++wx[m];
      }
      const uint32_t ctx = (p & 0xFFu) >> shift;
      const uint16_t* cr = cum + ctx * ct::CUM_STRIDE;
      const uint32_t t = rng[m] >> ct::QBITS;
      // invariant: cum[s] * t <= code < cum[s + 1] * t; c and h are the
      // cum values of the last right and left turn; k is the tree node
      // (CT-RCQ's row) or the lower end s (CT-RCX's sorted rows)
      constexpr bool TREE = INTERLEAVED;
      uint32_t k = TREE ? 1u : 0u, c = 0, h = ct::QTOTAL;
#pragma unroll
      for (int it = 0; it < 8; ++it) {
        const uint32_t at = TREE ? k : k | (128u >> it);
        const uint32_t v = cr[at];
        const bool right = v * t <= code[m];
        c = right ? v : c;
        h = right ? h : v;
        k = TREE ? 2 * k + (right ? 1u : 0u) : (right ? at : k);
      }
      const uint32_t sym = TREE ? k - 256 : k;
      code[m] -= c * t;
      rng[m] = (h == ct::QTOTAL) ? rng[m] - c * t : (h - c) * t;
#pragma unroll
      for (int slot = 0; slot < 2; ++slot) {
        if (rng[m] < ct::RC_TOP) {
          const uint32_t b = q0[m] >> 24;
          q0[m] = (q0[m] << 8) | (q1 >> 24);
          q1 &= LOW24;
          p -= OCC_ONE;
          code[m] = (code[m] << 8) | b;
          rng[m] <<= 8;
        }
      }
      pk[m] = (p & ~0xFFu) | sym;
      if constexpr (G > 1) {
        // to the owner's counts: this block's, or another's through
        // distributed shared memory
        uint32_t* cell = &C[(ctx / G) * 256 + sym];
        const unsigned owner = ctx % G;
        if (owner != (unsigned)g) cell = cg::this_cluster().map_shared_rank(cell, owner);
        atomicAdd(cell, inc);
      } else {
        atomicAdd(&C[ctx * 256 + sym], inc);
      }
      const size_t at = INTERLEAVED ? (size_t)j * K + lane : (size_t)lane * stride + j;
      out[at] = (uint8_t)sym;
    }
  }
  // no block leaves while the others may still add to its counts
  if constexpr (G > 1) cg::this_cluster().sync();
}

// Launches one instantiation: streams * G blocks, a cluster of G a stream;
// returns its cudaError_t (cudaErrorInvalidValue for a stride that packed
// lane state cannot hold).
template <int LPT, int ROUNDS, bool INTERLEAVED, bool GMODEL, int G>
cudaError_t launch_kernel(const void* words, const void* lane_len, void* out, void* gmodel,
                          int streams, int K, int l4, int stride, int inc, uint32_t climit,
                          int cbits, int wlog, cudaStream_t stream) {
  // packed: the word index, at most stride / 2 + 3, in 21 bits
  if (LPT >= 2 && stride > PACKED_MAX_STRIDE) return cudaErrorInvalidValue;
  const int rows = 1 << cbits, held = (rows + G - 1) / G;
  const size_t smem = GMODEL ? 0 : ct::model_bytes(rows) - (size_t)(rows - held) * 256 * 4;
  return ct::launch_streams<G>(rc_decode_kernel<LPT, ROUNDS, INTERLEAVED, GMODEL, G>, streams,
                               ct::coder_threads((K + G - 1) / G, held, INTERLEAVED), smem,
                               stream, (const uint32_t*)words, (const int32_t*)lane_len,
                               (uint8_t*)out, (uint8_t*)gmodel, K, l4, stride, (uint32_t)inc,
                               climit, cbits, wlog);
}

using LaunchFn = cudaError_t (*)(const void*, const void*, void*, void*, int, int, int, int, int,
                                 uint32_t, int, int, cudaStream_t);

// ------------------------------------------------------------------------
// The stepped lane-range form of C and E (ct_rcx_decode_steps,
// ct_rcq_decode_steps), for a stream whose K lanes are sharded over the
// ranks of a 'lane' group (parallel/sharded_rcx.py, sharded_rcq.py): a
// launch decodes one window, steps t0 .. t0 + steps - 1 (t0 a multiple of
// 2^wlog, steps <= 2^wlog), of lanes l0 .. l0 + ko - 1. Step t + 1's model
// needs every lane's symbol of step t, and a rank decodes only its own
// lanes, so one exchange of the symbols among the ranks a window is
// inherent; at wlog = 0 that is a launch and an exchange a step. Between
// launches the state stays in global memory, as kernel O keeps D's:
//   - st [6, ko] u32: each own lane's range, code, the queue's q0, q1, occ
//     and the next word's index (the one-shot kernel's registers);
//   - C [rows, 256] u32: the counts, after the last window's requant;
//   - prev [K] u8: every lane's symbol before the pending steps (its
//     context).
// A launch first adds the pending steps' symbols of every lane, xs [np, K]
// (the previous window, as the ranks exchanged them), to the counts, each
// lane in step order from its prev, then requantizes every row (a warp a
// row, ct::requant_row: a row that did not change requantizes to itself,
// as requant_changed's skip assumes), so the tables are the one-shot
// kernel's at that window; then each own lane decodes the window's steps
// against them, a thread a lane, in the one-shot kernel's arithmetic (the
// sorted search; E's tree order is a layout of the same search), and
// writes its symbols to out [steps, ko] (0 where the lane has ended).
// Lanes past their length keep their state, as in the one-shot kernel.
// What bounds it: not the card. A launch is a few microseconds of work for
// a step of a few thousand lanes, so the launch and the exchange between
// two launches set the pace.
template <int ROUNDS>
__global__ void __launch_bounds__(ct::MAX_THREADS)
    rc_decode_steps_kernel(const uint32_t* __restrict__ words, const int32_t* __restrict__ lane_len,
                           uint32_t* __restrict__ st, uint32_t* C, uint8_t* __restrict__ prev,
                           const uint8_t* __restrict__ xs, uint8_t* __restrict__ out, int K,
                           int l4, int l0, int ko, int t0, int steps, int np, uint32_t inc,
                           uint32_t climit, int cbits) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* cum = reinterpret_cast<uint16_t*>(smem);
  const int rows = 1 << cbits, shift = 8 - cbits;
  const size_t s = blockIdx.x;
  words += s * (size_t)l4 * ko;
  lane_len += s * K;
  st += s * 6 * (size_t)ko;
  C += s * (size_t)rows * 256;
  prev += s * K;
  xs += s * (size_t)np * K;
  out += s * (size_t)steps * ko;
  const int tid = threadIdx.x, bd = blockDim.x;

  // the pending window's updates, every lane, from its previous symbol
  for (int i = tid; i < K; i += bd) {
    const int len = lane_len[i];
    uint32_t p = prev[i];
    for (int u = 0; u < np && t0 - np + u < len; ++u) {
      const uint32_t sym = xs[(size_t)u * K + i];
      atomicAdd(&C[(p >> shift) * 256 + sym], inc);
      p = sym;
    }
    prev[i] = (uint8_t)p;
  }
  __syncthreads();
  for (int r = tid >> 5; r < rows; r += bd >> 5)
    ct::requant_row<ROUNDS>(C + (size_t)r * 256, cum + (size_t)r * ct::CUM_STRIDE, climit);
  __syncthreads();

  for (int i = tid; i < ko; i += bd) {
    const int len = lane_len[l0 + i];
    uint32_t rng = st[i], code = st[ko + i], q0 = st[2 * ko + i], q1 = st[3 * ko + i];
    uint32_t occ = st[4 * ko + i], widx = st[5 * ko + i], p = prev[l0 + i];
    for (int u = 0; u < steps; ++u) {
      uint32_t sym = 0;
      if (t0 + u < len) {
        if (occ < 2) {
          const uint32_t wd = widx < (uint32_t)l4 ? words[(size_t)widx * ko + i] : 0u;
          const bool empty = occ == 0;
          q0 |= empty ? wd : (wd >> 8);
          q1 |= empty ? 0u : (wd << 24);
          occ += 4;
          ++widx;
        }
        const uint16_t* cr = cum + (p >> shift) * ct::CUM_STRIDE;
        const uint32_t t = rng >> ct::QBITS;
        // the largest s with cum[s] * t <= code; c = cum[s], h = cum[s + 1]
        uint32_t k = 0, c = 0, h = ct::QTOTAL;
#pragma unroll
        for (int it = 0; it < 8; ++it) {
          const uint32_t at = k | (128u >> it);
          const uint32_t v = cr[at];
          const bool right = v * t <= code;
          c = right ? v : c;
          h = right ? h : v;
          k = right ? at : k;
        }
        code -= c * t;
        rng = (h == ct::QTOTAL) ? rng - c * t : (h - c) * t;
#pragma unroll
        for (int slot = 0; slot < 2; ++slot) {
          if (rng < ct::RC_TOP) {
            const uint32_t b = q0 >> 24;
            q0 = (q0 << 8) | (q1 >> 24);
            q1 <<= 8;
            --occ;
            code = (code << 8) | b;
            rng <<= 8;
          }
        }
        sym = p = k;
      }
      out[(size_t)u * ko + i] = (uint8_t)sym;
    }
    st[i] = rng;
    st[ko + i] = code;
    st[2 * ko + i] = q0;
    st[3 * ko + i] = q1;
    st[4 * ko + i] = occ;
    st[5 * ko + i] = widx;
  }
}

// Checks a stepped launch's window and launches one CTA a stream (up to
// 1,024 threads, at least a warp a row), the cum rows in dynamic shared
// memory; returns its cudaError_t.
template <int ROUNDS>
cudaError_t launch_decode_steps(const void* words, const void* lane_len, void* st, void* C,
                                void* prev, const void* xs, void* out, int streams, int K, int l4,
                                int l0, int ko, int t0, int steps, int np, int inc,
                                uint32_t climit, int cbits, int wlog, cudaStream_t stream) {
  const int w = 1 << wlog;
  if (streams < 1 || K < 1 || l0 < 0 || ko < 1 || l0 + ko > K || l4 < 1 || t0 < 0 ||
      t0 % w != 0 || steps < 1 || steps > w || np < 0 || np > w || np > t0 || cbits < 0 ||
      cbits > 8)
    return cudaErrorInvalidValue;
  const int rows = 1 << cbits;
  const size_t smem = ((size_t)rows * ct::CUM_STRIDE * 2 + 15) & ~(size_t)15;
  const int lanes = K > 32 * rows ? K : 32 * rows;
  return ct::launch_streams<1>(rc_decode_steps_kernel<ROUNDS>, streams, ct::block_threads(lanes),
                               smem, stream, (const uint32_t*)words, (const int32_t*)lane_len,
                               (uint32_t*)st, (uint32_t*)C, (uint8_t*)prev, (const uint8_t*)xs,
                               (uint8_t*)out, K, l4, l0, ko, t0, steps, np, (uint32_t)inc, climit,
                               cbits);
}

}  // namespace
