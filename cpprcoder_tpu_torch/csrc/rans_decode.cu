// Kernel G: CT-ANS1 v2 (interleaved rANS) decode on Hopper.
//
// Replaces the Pallas kernel cpprcoder_tpu/ops/rans_pallas.py:225
// `_decode_kernel` (pallas_call at rans_pallas.py:293).
//
// What it computes: per lane, from its final encoder state, for each step
// j < lane_len[i]: slot = st & (2^14 - 1), the symbol s that owns slot,
// st = f[s] * (st >> 14) + slot - cum[s], and one u16 refill
// st = (st << 16) | word when st < 2^16, the word taken at the lane's
// cursor in its row (0 past the row's end, as rans_ref.rans_decode reads).
// Symbol j of lane i goes to out[j*K + i], the original byte order.
//
// Design: lanes are independent (static table): one thread per lane,
// 128-thread blocks. Each block first builds a cum2sym[2^14] u8 table in
// shared memory (16 KB; every thread binary-searches cum for its share of
// the slots), which gives the symbol by one direct lookup where the Pallas
// kernel ran a two-level 16x16 one-hot search. The refill is one load of
// word `widx` from the word-major [l2, K] rows, coalesced across lanes
// that advance together.
//
// What bounds it: each lane's steps are one dependent chain (a lookup, a
// multiply, a possible refill load); with few lanes, as in small files, a
// call is latency-bound per step. Building cum2sym costs 128 slots and
// 8 shared reads a slot per thread per block.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t ANS_PROB_BITS = 14;
constexpr uint32_t ANS_TOTAL = 1u << ANS_PROB_BITS;
constexpr uint32_t ANS_LOW = 1u << 16;
constexpr int THREADS = 128;

// states [K] u32; rows [l2, K] i32 (u16 word values, zero past each lane's
// count); lane_len [K] i32; freq, cum [256] i32; out [stride, K] u8.
__global__ void __launch_bounds__(THREADS) rans_decode_kernel(const uint32_t* __restrict__ states,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ lane_len,
    const int32_t* __restrict__ freq, const int32_t* __restrict__ cum,
    uint8_t* __restrict__ out, int K, int l2, int stride) {
  __shared__ uint8_t c2s[ANS_TOTAL];
  __shared__ uint32_t fs[256], cs[257];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    fs[i] = (uint32_t)freq[i];
    cs[i] = (uint32_t)cum[i];
  }
  if (threadIdx.x == 0) cs[256] = (uint32_t)cum[255] + (uint32_t)freq[255];
  __syncthreads();
  for (uint32_t slot = threadIdx.x; slot < ANS_TOTAL; slot += blockDim.x) {
    int lo = 0, hi = 256;  // invariant: cs[lo] <= slot < cs[hi]
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int mid = (lo + hi) >> 1;
      if (cs[mid] <= slot)
        lo = mid;
      else
        hi = mid;
    }
    c2s[slot] = (uint8_t)lo;
  }
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= K) return;
  const int len = min(lane_len[lane], stride);
  uint32_t st = states[lane];
  int widx = 0;
  for (int j = 0; j < len; ++j) {
    const uint32_t slot = st & (ANS_TOTAL - 1u);
    const uint32_t s = c2s[slot];
    st = fs[s] * (st >> ANS_PROB_BITS) + slot - cs[s];
    if (st < ANS_LOW) {
      const uint32_t w = widx < l2 ? (uint32_t)rows[(size_t)widx * K + lane] : 0u;
      ++widx;
      st = (st << 16) | w;
    }
    out[(size_t)j * K + lane] = (uint8_t)s;
  }
}

}  // namespace

extern "C" int ct_rans_decode(const void* states, const void* rows, const void* lane_len,
                              const void* freq, const void* cum, void* out, int K, int l2,
                              int stride, void* stream) {
  rans_decode_kernel<<<(K + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)states, (const int32_t*)rows, (const int32_t*)lane_len,
      (const int32_t*)freq, (const int32_t*)cum, (uint8_t*)out, K, l2, stride);
  return (int)cudaGetLastError();
}
