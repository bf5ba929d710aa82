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
// lane, ceil(K / THREADS) CTAs, no block-wide synchronisation after the
// table load. A lane's steps form one dependent chain through its state,
// and the design keeps everything else off that chain:
//   - no divide: each symbol's table entry holds, beside f and c, the
//     reciprocal floor((2^32 - 1) / f), from which encode_step gets st / f
//     with one multiply-high and at most one correction (the argument is
//     there). One 8-byte shared read a step fetches all three;
//   - symbols loaded ahead: a lane's bytes do not depend on its state, so
//     after the ragged top (len % AHEAD steps) the loop walks runs of AHEAD
//     steps, unrolled and with no bound to check, the next run's bytes
//     loaded into registers while this run codes, and this run's table
//     entries read before its chain starts.
// Loads of x and stores of ev are K consecutive elements a step,
// coalesced across the warp.
//
// What bounds it: each lane's chain (a compare, a select, a multiply-high,
// a multiply-add, a compare, an add: about 6 dependent integer operations
// a step). Small files have few lanes and long chains (K = 2 over 1,861
// steps for grammar.lsp), so a call is latency-bound per step and fills a
// few warps of one SM at most.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t ANS_PROB_BITS = 14;
constexpr uint32_t ANS_TOTAL = 1u << ANS_PROB_BITS;
constexpr uint32_t ANS_LOW = 1u << 16;
constexpr int THREADS = 128;
constexpr int AHEAD = 16;  // steps a run: symbols loaded a run ahead

// One step of a lane: -> its event; st advanced. tab = (rcp, f | c << 16)
// with rcp = floor((2^32 - 1) / f).
//
// The quotient without a divide, exact for every u32 s and 1 <= f <= 2^14
// (so for every state a step sees: s < f << 18 after the emit test, any
// u32 at f = 2^14, which never emits). Write rcp = (2^32 - 1 - e) / f with
// 0 <= e < f. Then s * rcp / 2^32 = s / f - d with
// d = s * (1 + e) / (f * 2^32) <= s / 2^32 < 1, so the multiply-high
// q0 = floor(s * rcp / 2^32) is floor(s / f) or one less: one correction,
// q = q0 + (r0 >= f) with r0 = s - q0 * f, never two. The new state
// (q << 14) | (s % f + c) = s + c + q * (2^14 - f) is then formed from q0
// and the correction at once (mod 2^32; its exact value is below
// (q + 1) << 14 <= 2^32). The emit test st >= f << 18 compares st with
// (f << 18) - 1, which wraps to 2^32 - 1 at f = 2^14. The numpy mirror in
// tests/test_torch_rans_divide.py holds both for every f at the edge
// states.
__device__ __forceinline__ uint32_t encode_step(uint32_t& st, uint2 tab) {
  const uint32_t f = tab.y & 0xFFFFu, c = tab.y >> 16, g = ANS_TOTAL - f;
  const bool emit = st > (f << 18) - 1u;
  const uint32_t e = (emit ? 0x10000u : 0u) | (st & 0xFFFFu);
  const uint32_t s = emit ? st >> 16 : st;
  const uint32_t q0 = __umulhi(s, tab.x);
  const uint32_t r0 = s - q0 * f;
  st = s + c + q0 * g + (r0 >= f ? g : 0u);
  return e;
}

// x [stride, K] u8; lane_len [K] i32; freq, cum [256] i32;
// ev [stride, K] u32; states [K] u32.
__global__ void __launch_bounds__(THREADS) rans_encode_kernel(const uint8_t* __restrict__ x,
    const int32_t* __restrict__ lane_len, const int32_t* __restrict__ freq,
    const int32_t* __restrict__ cum, uint32_t* __restrict__ ev, uint32_t* __restrict__ states,
    int K, int stride) {
  __shared__ uint2 tab[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    const uint32_t f = (uint32_t)freq[i];
    // f = 0: a symbol the data does not hold, never coded
    tab[i] = make_uint2(f ? 0xFFFFFFFFu / f : 0u, f | ((uint32_t)cum[i] << 16));
  }
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= K) return;
  // the steps j < len are the lane's (the plain version's `j < lane_len`)
  const int len = max(0, min(lane_len[lane], stride));
  const uint8_t* xl = x + lane;
  uint32_t* el = ev + lane;
  // steps at and above the lane's length hold no symbol
  for (int j = len; j < stride; ++j) el[(size_t)j * K] = 0u;
  uint32_t st = ANS_LOW;
  // the top len % AHEAD steps one at a time, then runs of AHEAD steps, j
  // the first (highest) of a run, with no bound to check inside a run; nx
  // holds a run's bytes, loaded during the run before
  int j = len - 1;
  for (; j >= 0 && (j + 1) % AHEAD != 0; --j)
    el[(size_t)j * K] = encode_step(st, tab[xl[(size_t)j * K]]);
  uint32_t nx[AHEAD];
  if (j >= 0) {
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) nx[u] = xl[(size_t)(j - u) * K];
  }
  for (; j >= 0; j -= AHEAD) {
    uint2 t[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) t[u] = tab[nx[u]];
    if (j >= AHEAD) {
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) nx[u] = xl[(size_t)(j - AHEAD - u) * K];
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) el[(size_t)(j - u) * K] = encode_step(st, t[u]);
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
