// Kernel H: CT-HUF1 (canonical Huffman) encode on Hopper.
//
// Replaces the Pallas kernel cpprcoder_tpu/ops/huffman_pallas.py:79
// `_encode_kernel` (pallas_call at huffman_pallas.py:143).
//
// What it computes: K interleaved lanes (lane i codes x[j*K + i] at step
// j < lane_len[i]) against one static table of (length <= 15, LSB-first
// code). Per active step: acc |= code << nb; nb += len; bits += len; the
// event ev[j, i] is (nb >= 16) << 16 | (acc & 0xFFFF), and on emit the
// word leaves the accumulator (acc >>= 16, nb -= 16). Inactive steps write
// 0. Per lane at the end: flush[i] = (nb > 0) << 16 | (acc & 0xFFFF) when
// bits remain, else 0, and bits[i] = the lane's bit count.
//
// Design: the table is static, so lanes are independent: one thread per
// lane, 128-thread blocks, ceil(K / 128) CTAs, no synchronisation after the
// table load. The table sits in shared memory as one u32 a symbol,
// len << 16 | code, so a step does one shared read; shifts are real shifts
// (nb < 16 before the OR and codes are below 2^15, so code << nb < 2^31),
// where the Pallas kernel read the table with a one-hot MXU product and
// shifted through a 16-way select ladder. Loads of x and stores of ev are
// K consecutive elements a step, coalesced across the warp.
//
// What bounds it: by bytes, each x byte read once and each 4-byte event
// written once (kennedy.xls: about 5.2 MB, 1.5 us at 3.35 TB/s). In fact
// each lane is one dependent chain of stride steps (a byte load, a shared
// read, a few integer ops), and few lanes fill a few warps of one SM, so a
// call is latency-bound per step, far above that bound.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

// x [stride, K] u8; lane_len [K] i32; tab [2, 256] i32 (lengths, codes);
// ev [stride, K] u32; flush [K] u32; bits [K] u32.
__global__ void __launch_bounds__(THREADS) huffman_encode_kernel(const uint8_t* __restrict__ x,
    const int32_t* __restrict__ lane_len, const int32_t* __restrict__ tab,
    uint32_t* __restrict__ ev, uint32_t* __restrict__ flush, uint32_t* __restrict__ bits_out,
    int K, int stride) {
  __shared__ uint32_t lc[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    lc[i] = ((uint32_t)tab[i] << 16) | (uint32_t)tab[256 + i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= K) return;
  const int len = lane_len[lane];
  uint32_t acc = 0, nb = 0, bits = 0;
  for (int j = 0; j < stride; ++j) {
    uint32_t e = 0;
    if (j < len) {
      const uint32_t v = lc[x[(size_t)j * K + lane]];
      const uint32_t l = v >> 16;
      acc |= (v & 0xFFFFu) << nb;
      nb += l;
      bits += l;
      const bool emit = nb >= 16;
      e = (emit ? 0x10000u : 0u) | (acc & 0xFFFFu);
      if (emit) {
        acc >>= 16;
        nb -= 16;
      }
    }
    ev[(size_t)j * K + lane] = e;
  }
  flush[lane] = nb > 0 ? (0x10000u | (acc & 0xFFFFu)) : 0u;
  bits_out[lane] = bits;
}

}  // namespace

extern "C" int ct_huffman_encode(const void* x, const void* lane_len, const void* tab, void* ev,
                                 void* flush, void* bits, int K, int stride, void* stream) {
  huffman_encode_kernel<<<(K + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, (const int32_t*)lane_len, (const int32_t*)tab, (uint32_t*)ev,
      (uint32_t*)flush, (uint32_t*)bits, K, stride);
  return (int)cudaGetLastError();
}
