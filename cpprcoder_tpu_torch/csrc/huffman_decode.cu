// Kernel I: CT-HUF1 (canonical Huffman) decode on Hopper.
//
// Replaces the Pallas kernel cpprcoder_tpu/ops/huffman_pallas.py:220
// `_decode_kernel` (pallas_call at huffman_pallas.py:298).
//
// What it computes: per lane, a bit queue (win, nb) fed from the lane's
// u16 words. Per step j < lane_len[i]: while nb <= 16 take one word (the
// word at the lane's cursor in its row, 0 past l2) into win at bit nb;
// r = the low 15 bits of win bit-reversed (__brev(win) >> 17); the code
// length l = 16 - #{l in 1..15 : r < limits[l]}, which is the first l with
// r < limits[l] since the limits do not decrease; the symbol is
// perm[clamp((r >> (15 - l)) - bases[l], 0, 255)]; consume l bits. A
// window no code matches (l = 16: an incomplete single-symbol code past
// its bits, or a corrupt container) decodes as perm[0] and consumes 16
// bits, as the plain version (ops/huffman_ops.py) does. Symbol j of lane i
// goes to out[j*K + i], the original byte order.
//
// Design: lanes are independent (static code): one thread per lane,
// THREADS-thread blocks. The canonical tables (limits and bases, 16 u32
// each, perm 256 u8) sit in shared memory; limits are then held in
// registers, so the length is 15 compares without a memory read; a table
// of 2^LUT_BITS (length, symbol) entries in shared memory gives codes of up
// to LUT_BITS bits in one read, the compares the others. A step
// is one lane's dependent chain, and a word read issued in the step that
// needs it would put a global load's latency into every refill (a refill
// comes every 3 to 4 steps on text). So each lane keeps its next AHEAD
// words in flight: a ring of AHEAD + 1 words a lane in shared memory, fed
// by cp.async, which lands a word without a register waiting on it (a
// queue of registers would stall at its first move of a word still in
// flight). A refill waits until the oldest copy has landed, reads it, and
// issues the copy of the word AHEAD refills ahead into the slot the refill
// before read; copies past l2 fill zeros and read nothing. Where the Pallas
// kernel summed one-hot rows for the refill and the bases, read perm with
// an MXU product and shifted through select ladders, this reads and shifts
// directly.
//
// What bounds it: by bytes, the word rows read once and one output byte
// a symbol (kennedy.xls: about 2 MB, 0.6 us at 3.35 TB/s). In fact each
// lane is one dependent chain of steps (the window's reversal, the
// compares, two shared reads, the shifts), and a call is latency-bound per
// step.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr int AHEAD = 8;  // words a lane keeps in flight
// a window's top LUT_BITS bits index a table of (length, symbol) for the
// codes of at most that many bits (0: no table)
constexpr int LUT_BITS = 12;
constexpr uint32_t MAX_BITS = 15;

// The code length of window r: 16 - #{l in 1..15 : r < lim[l]} (16: no
// code matches).
__device__ __forceinline__ uint32_t code_length(uint32_t r, const uint32_t* lim) {
  uint32_t below = 0;
#pragma unroll
  for (int l = 1; l <= (int)MAX_BITS; ++l) below += r < lim[l] ? 1u : 0u;
  return MAX_BITS + 1 - below;
}

// The symbol's rank in perm of window r with code length l (0 for l = 16).
__device__ __forceinline__ int code_rank(uint32_t r, uint32_t l, const uint32_t* bas) {
  if (l > MAX_BITS) return 0;
  const int rank = (int)((r >> (MAX_BITS - l)) - bas[l]);
  return min(max(rank, 0), 255);
}

// Copies the 4 bytes at src into shared dst without waiting (zeros, and no
// read, unless ok), as one commit group of this thread.
__device__ __forceinline__ void copy_word_async(uint32_t* dst, const int32_t* src, bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// rows [l2, K] i32 (u16 word values, zero past each lane's count); lane_len
// [K] i32; limits, bases [16] i32 (u32 bits); perm [256] i32; out
// [stride, K] u8.
__global__ void __launch_bounds__(THREADS) huffman_decode_kernel(const int32_t* __restrict__ rows,
    const int32_t* __restrict__ lane_len, const int32_t* __restrict__ limits,
    const int32_t* __restrict__ bases, const int32_t* __restrict__ perm,
    uint8_t* __restrict__ out, int K, int l2, int stride) {
  __shared__ uint32_t lim_s[16], bas_s[16];
  __shared__ uint8_t perm_s[256];
  __shared__ uint32_t ring[AHEAD + 1][THREADS];  // slot k of thread t: ring[k][t]
  __shared__ uint16_t lut[LUT_BITS > 0 ? 1 << LUT_BITS : 1];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    perm_s[i] = (uint8_t)perm[i];
    if (i < 16) {
      lim_s[i] = (uint32_t)limits[i];
      bas_s[i] = (uint32_t)bases[i];
    }
  }
  __syncthreads();
  if constexpr (LUT_BITS > 0) {
    // entry i: the windows whose top LUT_BITS bits are i share one code
    // when their lowest and highest share a length l <= LUT_BITS (lengths
    // grow with r), and then (l << 8) | symbol; else 0, the compares
    constexpr uint32_t LOW = (1u << (MAX_BITS - LUT_BITS)) - 1;
    for (int i = threadIdx.x; i < 1 << LUT_BITS; i += blockDim.x) {
      const uint32_t r = (uint32_t)i << (MAX_BITS - LUT_BITS);
      const uint32_t l = code_length(r, lim_s);
      lut[i] = l == code_length(r | LOW, lim_s) && l <= (uint32_t)LUT_BITS
                   ? (uint16_t)((l << 8) | perm_s[code_rank(r, l, bas_s)])
                   : (uint16_t)0;
    }
    __syncthreads();
  }
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= K) return;
  uint32_t lim[MAX_BITS + 1];
#pragma unroll
  for (int l = 1; l <= (int)MAX_BITS; ++l) lim[l] = lim_s[l];

  const int len = min(lane_len[lane], stride);
  const int32_t* col = rows + lane;  // word w of the lane: col[w * K]
  uint32_t* mine = &ring[0][threadIdx.x];
  // word w lands in slot w % (AHEAD + 1); words 0 .. AHEAD-1 now
#pragma unroll
  for (int w = 0; w < AHEAD; ++w)
    copy_word_async(mine + w * THREADS, w < l2 ? col + (size_t)w * K : col, w < l2);
  uint32_t win = 0, nb = 0;
  int slot = 0, wn = AHEAD;  // the slot of the next word taken; the next word copied
  for (int j = 0; j < len; ++j) {
    if (nb <= 16) {
      // the oldest of the AHEAD copies in flight has landed
      asm volatile("cp.async.wait_group %0;\n" ::"n"(AHEAD - 1) : "memory");
      win |= mine[slot * THREADS] << nb;
      nb += 16;
      const int back = slot == 0 ? AHEAD : slot - 1;  // read one refill ago
      copy_word_async(mine + back * THREADS, wn < l2 ? col + (size_t)wn * K : col, wn < l2);
      ++wn;
      slot = slot == AHEAD ? 0 : slot + 1;
    }
    const uint32_t r = __brev(win) >> 17;
    uint32_t e = LUT_BITS > 0 ? lut[r >> (MAX_BITS - LUT_BITS)] : 0u;  // (l << 8) | symbol
    if (e == 0) {
      const uint32_t l = code_length(r, lim);
      e = (l << 8) | perm_s[code_rank(r, l, bas_s)];
    }
    out[(size_t)j * K + lane] = (uint8_t)e;
    win >>= e >> 8;
    nb -= e >> 8;
  }
  // no copy is left in flight into a block's shared memory past its end
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace

extern "C" int ct_huffman_decode(const void* rows, const void* lane_len, const void* limits,
                                 const void* bases, const void* perm, void* out, int K, int l2,
                                 int stride, void* stream) {
  huffman_decode_kernel<<<(K + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)rows, (const int32_t*)lane_len, (const int32_t*)limits,
      (const int32_t*)bases, (const int32_t*)perm, (uint8_t*)out, K, l2, stride);
  return (int)cudaGetLastError();
}
