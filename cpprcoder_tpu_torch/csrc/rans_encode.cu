// Kernel F: CT-ANS1 v2 (interleaved rANS) encode on Hopper.
//
// Replaces the Pallas kernel cpprcoder_tpu/ops/rans_pallas.py:76
// `_encode_kernel` (pallas_call at rans_pallas.py:156).
//
// What it computes: K interleaved lanes (lane i codes x[j*K + i] at step
// j < lane_len[i]) against one static table (freq, exclusive cum) summing
// to 2^14, walking the steps backwards (the rANS encoder runs in reverse
// so that the decoder reads forwards). Per active step: emit the state's
// low u16 word when (st >> 18) >= f (the wrap-free form of st >= f << 18),
// then st = ((st / f) << 14) | (st % f + c). Event ev[j, i] is
// (emit << 16) | (st & 0xFFFF) before the step, 0 where the lane is
// inactive; the final states go to states[i].
//
// Design: the table is static, so lanes are independent: one thread per
// lane, 128-thread blocks, ceil(K / 128) CTAs, no block-wide
// synchronisation after the table load. freq and cum sit in shared memory
// and are read by direct indexing; the hardware integer divide replaces
// the Pallas kernel's 18-round long division. Loads of x and stores of ev
// are K consecutive elements a step, coalesced across the warp.
//
// What bounds it: each lane's steps form one dependent chain (a shared
// read, a 32-bit divide, a few integer ops). Small files have few lanes
// and long chains (K = 2 over 1,861 steps for grammar.lsp), so a call is
// latency-bound per step and fills a few warps of one SM at most.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t ANS_PROB_BITS = 14;
constexpr uint32_t ANS_LOW = 1u << 16;
constexpr int THREADS = 128;

// x [stride, K] u8; lane_len [K] i32; freq, cum [256] i32;
// ev [stride, K] u32; states [K] u32.
__global__ void __launch_bounds__(THREADS) rans_encode_kernel(const uint8_t* __restrict__ x,
    const int32_t* __restrict__ lane_len, const int32_t* __restrict__ freq,
    const int32_t* __restrict__ cum, uint32_t* __restrict__ ev, uint32_t* __restrict__ states,
    int K, int stride) {
  __shared__ uint32_t fs[256], cs[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    fs[i] = (uint32_t)freq[i];
    cs[i] = (uint32_t)cum[i];
  }
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= K) return;
  const int len = lane_len[lane];
  uint32_t st = ANS_LOW;
  for (int j = stride - 1; j >= 0; --j) {
    uint32_t e = 0;
    if (j < len) {
      const uint32_t s = x[(size_t)j * K + lane];
      const uint32_t f = fs[s];
      const uint32_t c = cs[s];
      const bool emit = (st >> 18) >= f;
      e = (emit ? 0x10000u : 0u) | (st & 0xFFFFu);
      if (emit) st >>= 16;
      const uint32_t q = st / f;
      st = (q << ANS_PROB_BITS) | (st - q * f + c);
    }
    ev[(size_t)j * K + lane] = e;
  }
  states[lane] = st;
}

}  // namespace

extern "C" int ct_rans_encode(const void* x, const void* lane_len, const void* freq,
                              const void* cum, void* ev, void* states, int K, int stride,
                              void* stream) {
  rans_encode_kernel<<<(K + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, (const int32_t*)lane_len, (const int32_t*)freq, (const int32_t*)cum,
      (uint32_t*)ev, (uint32_t*)states, K, stride);
  return (int)cudaGetLastError();
}
