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
// 128-thread blocks. The canonical tables (limits and bases, 16 u32 each,
// perm 256 u8) sit in shared memory, 384 bytes; limits are then held in
// registers, so the length is 15 compares without a memory read. The
// oracle's 2^15-entry LUT (64 KB) would need opt-in dynamic shared memory
// and a 16x larger per-block fill for one lookup a step; the compares cost
// less than that fill at the corpus's few lanes. Where the Pallas kernel
// summed one-hot rows for the refill and the bases, read perm with an MXU
// product and shifted through select ladders, this reads and shifts
// directly.
//
// What bounds it: by bytes, the word rows read once and one output byte
// a symbol (kennedy.xls: about 2 MB, 0.6 us at 3.35 TB/s). In fact each
// lane is one dependent chain of steps (a refill load every few steps, the
// compares, a shared read), and a call is latency-bound per step.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr uint32_t MAX_BITS = 15;

// rows [l2, K] i32 (u16 word values, zero past each lane's count); lane_len
// [K] i32; limits, bases [16] i32 (u32 bits); perm [256] i32; out
// [stride, K] u8.
__global__ void __launch_bounds__(THREADS) huffman_decode_kernel(const int32_t* __restrict__ rows,
    const int32_t* __restrict__ lane_len, const int32_t* __restrict__ limits,
    const int32_t* __restrict__ bases, const int32_t* __restrict__ perm,
    uint8_t* __restrict__ out, int K, int l2, int stride) {
  __shared__ uint32_t lim_s[16], bas_s[16];
  __shared__ uint8_t perm_s[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    perm_s[i] = (uint8_t)perm[i];
    if (i < 16) {
      lim_s[i] = (uint32_t)limits[i];
      bas_s[i] = (uint32_t)bases[i];
    }
  }
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= K) return;
  uint32_t lim[MAX_BITS + 1];
#pragma unroll
  for (int l = 1; l <= (int)MAX_BITS; ++l) lim[l] = lim_s[l];

  const int len = min(lane_len[lane], stride);
  uint32_t win = 0, nb = 0;
  int wcur = 0;
  for (int j = 0; j < len; ++j) {
    if (nb <= 16) {
      const uint32_t w = wcur < l2 ? (uint32_t)rows[(size_t)wcur * K + lane] : 0u;
      win |= w << nb;
      nb += 16;
      ++wcur;
    }
    const uint32_t r = __brev(win) >> 17;
    uint32_t below = 0;
#pragma unroll
    for (int l = 1; l <= (int)MAX_BITS; ++l) below += r < lim[l] ? 1u : 0u;
    const uint32_t l = MAX_BITS + 1 - below;
    int rank = 0;
    if (l <= MAX_BITS) {
      rank = (int)((r >> (MAX_BITS - l)) - bas_s[l]);
      rank = min(max(rank, 0), 255);
    }
    out[(size_t)j * K + lane] = perm_s[rank];
    win >>= l;
    nb -= l;
  }
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
