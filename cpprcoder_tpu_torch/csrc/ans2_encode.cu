// Kernels W and X: CT-ANS2 (the adaptive interleaved rANS) encode on Hopper.
//
// They replace no Pallas kernel: the JAX package runs this encode as three
// passes in one jit (cpprcoder_tpu/ops/ans2_ops.py:86 `_encode_fn`). W
// replaces pass A, the model over windows (`:99-137`: the warm-up windows
// unrolled, then the lax.scan at `:126`); X replaces pass C, the reverse
// coding scan (`:153-177`), and pass B (`:139-151`), which reads each
// position's (f, c) by a one-hot matrix product because Mosaic has no
// gather: X reads its window's table by index.
//
// What they compute (reference/ans2_ref.py): K interleaved lanes (lane j
// codes x[t*K + j] at step t, n bytes in all) share one model, counts
// starting at 1. Window w covers steps [window_start(w), window_start(w+1))
// (ans2_model.cuh). At its start, if the total has reached 2^limit_log2,
// counts = (counts >> 1) | 1; its table is normalize(counts); after it,
// every symbol it coded adds inc to its count.
//
// W, three launches after a memset of the histograms:
//   hist  a CTA a (window, tile of TILE positions): the tile's histogram in
//         shared memory, added to the window's with global atomics;
//   walk  one CTA, a thread a symbol: the rescale walk over the windows
//         (sequential, but 256 counts wide, 64-bit), each window's counts
//         after its rescale into counts [n_snap, 256]; a CTA-wide sum only
//         where a rescale fires, the total otherwise grown by inc times the
//         window's coded positions;
//   norm  a CTA a window: the normalize, -> freqs, cums [n_snap, 256].
// X (second round; the first read every step's entry from global memory
// and divided for its reciprocal a step): kernel F's coder
// (csrc/rans_encode.cu), a thread a lane in CTAs of 128, walking the lane's
// steps backwards; step t codes with table snapshot_index(t). Lane lengths
// differ by at most one, so every lane of a CTA crosses a window edge at
// the same step: the CTA stages the current window's table in shared
// memory as (rcp, f | c << 16), rcp = floor((2^32 - 1) / f) formed once a
// window (two divides a thread), the next window's (f, c) loaded during
// the current one, one barrier a window. From step 16 on, where windows
// are 16 steps or more (refresh_log2 >= 4), the steps run as F's: runs of
// 16, a run's bytes loaded during the run before, its entries read from
// the staged table at its start, the step F's (`encode_step`, its
// exactness argument there and in tests/test_torch_rans_divide.py). The
// first 16 steps, and every step at refresh_log2 < 4, read their entries
// from global memory a run ahead (the first design). Measured and left
// out (PERF.md, section 6): CTAs of 32 lanes (slower wherever tables are
// staged), windows of 8 steps staged in runs of 8 (a barrier every run:
// slower than global reads at K = 2,048). Events ev[t, j] are (emit <<
// 16) | (st & 0xFFFF) before the step, 0 where the lane is inactive.
//
// What bounds them: W moves n bytes and writes 16 bytes a table cell (a
// few microseconds of memory time at kennedy.xls); its walk is n_snap
// dependent rounds of one CTA, its normalize a few microseconds a window,
// all windows at once. X, like F, is bound by each lane's chain of about 6
// dependent integer operations a step, and a barrier a window; K = 2
// lanes over 1,861 steps (grammar.lsp) fill one warp of one SM.
#include <cstdint>
#include <cuda_runtime.h>

#include "ans2_model.cuh"

namespace {

using namespace ans2;

constexpr int HIST_THREADS = 256;
constexpr int TILE = 16384;   // positions a histogram CTA
constexpr int THREADS = 128;  // X: lanes a CTA
constexpr int AHEAD = 16;     // X: steps a run
constexpr int STAGE_LOG2 = 4; // X: windows of 2^4 = AHEAD steps and more are staged
constexpr int NS = 256 / THREADS;  // X: table entries a thread stages

// x [steps*K] u8; hist [n_snap, 256] u32, zeroed.
__global__ void __launch_bounds__(HIST_THREADS)
    ans2_hist_kernel(const uint8_t* __restrict__ x, uint32_t* __restrict__ hist, long long n,
                     int K, int steps, int r) {
  __shared__ uint32_t h[256];
  const unsigned long long w = blockIdx.x;
  const unsigned long long a = window_start(w, r);
  unsigned long long b = window_start(w + 1, r);
  if (b > (unsigned long long)steps) b = steps;
  const unsigned long long end = b * K < (unsigned long long)n ? b * K : (unsigned long long)n;
  unsigned long long lo = a * K + (unsigned long long)blockIdx.y * TILE;
  if (lo >= end) return;
  h[threadIdx.x] = 0;
  __syncthreads();
  // the window's tiles blockIdx.y, + gridDim.y, ... (gridDim.y <= 65,535)
  for (; lo < end; lo += (unsigned long long)gridDim.y * TILE) {
    const unsigned long long hi = end < lo + TILE ? end : lo + TILE;
    for (unsigned long long p = lo + threadIdx.x; p < hi; p += HIST_THREADS)
      atomicAdd(&h[x[p]], 1u);
  }
  __syncthreads();
  const uint32_t v = h[threadIdx.x];
  if (v) atomicAdd(&hist[w * 256 + threadIdx.x], v);
}

// hist [n_snap, 256] u32 -> counts [n_snap, 256] u64: the counts each
// window's table is normalized from. One CTA of 256.
__global__ void __launch_bounds__(NORM_THREADS)
    ans2_walk_kernel(const uint32_t* __restrict__ hist, unsigned long long* __restrict__ counts,
                     long long n, int K, int steps, int r, int n_snap, uint32_t inc,
                     int limit_log2) {
  __shared__ Scratch sc;
  const int s = threadIdx.x;
  const bool can_rescale = limit_log2 < 64;
  const unsigned long long limit = can_rescale ? 1ull << limit_log2 : 0;
  unsigned long long cnt = 1, total = 256;
  uint32_t h = hist[s];  // window 0's, read a window ahead
  for (int w = 0; w < n_snap; ++w) {
    if (can_rescale && total >= limit) {
      cnt = (cnt >> 1) | 1;
      total = block_sum(cnt, sc);
    }
    counts[(size_t)w * 256 + s] = cnt;
    const uint32_t hw = h;
    if (w + 1 < n_snap) h = hist[(size_t)(w + 1) * 256 + s];
    cnt += (unsigned long long)inc * hw;
    unsigned long long b = window_start(w + 1, r);
    if (b > (unsigned long long)steps) b = steps;
    total += (unsigned long long)inc * coded(window_start(w, r), b, n, K);
  }
}

// counts [B, 256] u64 -> freqs, cums [B, 256] i32. A CTA a row.
__global__ void __launch_bounds__(NORM_THREADS)
    ans2_norm_kernel(const unsigned long long* __restrict__ counts, int32_t* __restrict__ freq,
                     int32_t* __restrict__ cum) {
  __shared__ Scratch sc;
  const size_t at = (size_t)blockIdx.x * 256 + threadIdx.x;
  uint32_t c;
  const uint32_t f = normalize(counts[at], sc, c);
  freq[at] = (int32_t)f;
  cum[at] = (int32_t)c;
}

// Table entry (rcp, f | c << 16), rcp = floor((2^32 - 1) / f) (0 for f =
// 0, a symbol that is never coded).
__device__ __forceinline__ uint2 make_entry(uint32_t f, uint32_t c) {
  return make_uint2(f ? 0xFFFFFFFFu / f : 0u, f | (c << 16));
}

// Symbol s's entry in table w, from global memory.
__device__ __forceinline__ uint2 entry(const int32_t* __restrict__ freq,
                                       const int32_t* __restrict__ cum, uint32_t w, uint32_t s) {
  const size_t at = (size_t)w * 256 + s;
  return make_entry((uint32_t)__ldg(freq + at), (uint32_t)__ldg(cum + at));
}

// Table w's (f, c) of symbols threadIdx.x + i * THREADS, into registers.
__device__ __forceinline__ void stage_load(const int32_t* __restrict__ freq,
                                           const int32_t* __restrict__ cum, uint32_t w,
                                           uint32_t (&f)[NS], uint32_t (&c)[NS]) {
  const size_t row = (size_t)w * 256 + threadIdx.x;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    f[i] = (uint32_t)__ldg(freq + row + i * THREADS);
    c[i] = (uint32_t)__ldg(cum + row + i * THREADS);
  }
}

// Their entries, reciprocals formed, into a table in shared memory.
__device__ __forceinline__ void stage_store(uint2* tab, const uint32_t (&f)[NS],
                                            const uint32_t (&c)[NS]) {
#pragma unroll
  for (int i = 0; i < NS; ++i) tab[threadIdx.x + i * THREADS] = make_entry(f[i], c[i]);
}

// Kernel F's step: -> the event; st advanced (csrc/rans_encode.cu has its
// exactness argument).
__device__ __forceinline__ uint32_t encode_step(uint32_t& st, uint2 tab) {
  const uint32_t f = tab.y & 0xFFFFu, c = tab.y >> 16, g = TOTAL - f;
  const bool emit = st > (f << 18) - 1u;
  const uint32_t e = (emit ? 0x10000u : 0u) | (st & 0xFFFFu);
  const uint32_t s = emit ? st >> 16 : st;
  const uint32_t q0 = __umulhi(s, tab.x);
  const uint32_t r0 = s - q0 * f;
  st = s + c + q0 * g + (r0 >= f ? g : 0u);
  return e;
}

// x [stride, K] u8; lane_len [K] i32; freq, cum [n_snap, 256] i32;
// ev [stride, K] u32; states [K] u32. Lane lengths differ by at most one,
// so every lane of a CTA crosses a window edge at the same step.
__global__ void __launch_bounds__(THREADS)
    ans2_encode_kernel(const uint8_t* __restrict__ x, const int32_t* __restrict__ lane_len,
                       const int32_t* __restrict__ freq, const int32_t* __restrict__ cum,
                       uint32_t* __restrict__ ev, uint32_t* __restrict__ states, int K, int stride,
                       int r) {
  __shared__ uint2 tabs[2][256];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool real = lane < K;
  const int len = real ? max(0, min(lane_len[lane], stride)) : 0;
  const uint8_t* xl = x + lane;
  uint32_t* el = ev + lane;
  if (real)
    for (int j = len; j < stride; ++j) el[(size_t)j * K] = 0u;
  uint32_t st = LOW;
  // The staged steps [t0, stride), every window there at least AHEAD steps
  // long and starting at a multiple of AHEAD: window w's table in
  // tabs[w & 1], the next window's loaded during it and formed at its end
  // (one barrier a window). The top run's steps one at a time, then runs of
  // AHEAD steps as kernel F's: a run's bytes loaded during the run before,
  // its entries read from the table at its start, no bound checked inside.
  const int t0 = r >= STAGE_LOG2 && stride > AHEAD ? AHEAD : stride;
  if (t0 < stride) {
    uint32_t w = snapshot_index(stride - 1, r);
    uint32_t pf[NS], pc[NS];
    stage_load(freq, cum, w, pf, pc);
    stage_store(tabs[w & 1], pf, pc);
    __syncthreads();
    unsigned long long edge = window_start(w, r);  // window w's first step
    if (edge > (unsigned long long)t0) stage_load(freq, cum, w - 1, pf, pc);
    const int m0 = t0 / AHEAD;
    int m = (stride - 1) / AHEAD;  // the top run, steps [AHEAD*m, stride)
    for (int t = len - 1; t >= AHEAD * m; --t)
      el[(size_t)t * K] = encode_step(st, tabs[w & 1][xl[(size_t)t * K]]);
    uint32_t nx[AHEAD];
    for (;;) {
      if ((unsigned long long)(AHEAD * m) == edge && m > m0) {
        stage_store(tabs[(w - 1) & 1], pf, pc);
        __syncthreads();
        edge = window_start(--w, r);
        if (edge > (unsigned long long)t0) stage_load(freq, cum, w - 1, pf, pc);
      }
      if (--m < m0) break;
      if (m == (stride - 1) / AHEAD - 1 && real) {
#pragma unroll
        for (int u = 0; u < AHEAD; ++u) nx[u] = xl[(size_t)(AHEAD * m + u) * K];
      }
      if (real) {
        const uint2* tab = tabs[w & 1];
        uint2 e[AHEAD];
#pragma unroll
        for (int u = 0; u < AHEAD; ++u) e[u] = tab[nx[u]];
        if (m > m0) {
#pragma unroll
          for (int u = 0; u < AHEAD; ++u) nx[u] = xl[(size_t)(AHEAD * (m - 1) + u) * K];
        }
#pragma unroll
        for (int u = AHEAD - 1; u >= 0; --u)
          el[(size_t)(AHEAD * m + u) * K] = encode_step(st, e[u]);
      }
    }
  }
  if (!real) return;
  // The steps below t0, windows shorter than 2^STAGE_LOG2 (all of them at
  // refresh_log2 < STAGE_LOG2), read from global memory: the top
  // dl % AHEAD steps one at a time, then runs of AHEAD steps, j the first
  // (highest) of a run: t holds its entries, read during the run before,
  // and nx the next run's bytes, read two runs before; so the chain itself
  // waits on no load.
  const int dl = min(t0, len);
  int j = dl - 1;
  for (; j >= 0 && (j + 1) % AHEAD != 0; --j)
    el[(size_t)j * K] = encode_step(st, entry(freq, cum, snapshot_index(j, r), xl[(size_t)j * K]));
  if (j >= 0) {
    uint32_t nx[AHEAD];
    uint2 tn[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) nx[u] = xl[(size_t)(j - u) * K];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) tn[u] = entry(freq, cum, snapshot_index(j - u, r), nx[u]);
    if (j >= AHEAD) {
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) nx[u] = xl[(size_t)(j - AHEAD - u) * K];
    }
    for (; j >= 0; j -= AHEAD) {
      uint2 t[AHEAD];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) t[u] = tn[u];
      if (j >= AHEAD) {
#pragma unroll
        for (int u = 0; u < AHEAD; ++u)
          tn[u] = entry(freq, cum, snapshot_index(j - AHEAD - u, r), nx[u]);
        if (j >= 2 * AHEAD) {
#pragma unroll
          for (int u = 0; u < AHEAD; ++u) nx[u] = xl[(size_t)(j - 2 * AHEAD - u) * K];
        }
      }
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) el[(size_t)(j - u) * K] = encode_step(st, t[u]);
    }
  }
  states[lane] = st;
}

}  // namespace

// W: x [steps, K] u8 (zero past n) -> freqs, cums [n_snap, 256] i32, with
// hist [n_snap, 256] u32 and counts [n_snap, 256] u64 as scratch. r is the
// effective refresh_log2 (at most 31: ans2_ops.refresh_eff), limit_log2 at
// most 63 (no total reaches 2^63).
extern "C" int ct_ans2_model(const void* x, void* hist, void* counts, void* freq, void* cum,
                             long long n, int K, int steps, int inc, int limit_log2, int r,
                             int n_snap, void* stream) {
  if (K < 1 || K > 65536 || (K & (K - 1)) || steps < 1 || r < 0 || r > 31 || n < 1 ||
      n > (long long)K * steps || n <= (long long)K * (steps - 1) || n_snap < 1 || inc < 0 ||
      inc > 255 || limit_log2 < 0 || limit_log2 > 63)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(hist, 0, (size_t)n_snap * 256 * 4, s);
  if (e != cudaSuccess) return (int)e;
  // no window is longer than 2^r steps or than the stream
  const unsigned long long longest =
      ((unsigned long long)steps < (1ull << r) ? (unsigned long long)steps : 1ull << r) * K;
  const unsigned long long tiles = (longest + TILE - 1) / TILE;
  const dim3 grid(n_snap, (unsigned)(tiles < 65535 ? tiles : 65535));
  ans2_hist_kernel<<<grid, HIST_THREADS, 0, s>>>((const uint8_t*)x, (uint32_t*)hist, n, K, steps,
                                                 r);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ans2_walk_kernel<<<1, NORM_THREADS, 0, s>>>((const uint32_t*)hist, (unsigned long long*)counts,
                                              n, K, steps, r, n_snap, (uint32_t)inc, limit_log2);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ans2_norm_kernel<<<n_snap, NORM_THREADS, 0, s>>>((const unsigned long long*)counts,
                                                   (int32_t*)freq, (int32_t*)cum);
  return (int)cudaGetLastError();
}

// The normalize alone: counts [B, 256] u64 -> freqs, cums [B, 256] i32.
extern "C" int ct_ans2_normalize(const void* counts, void* freq, void* cum, int B, void* stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  ans2_norm_kernel<<<B, NORM_THREADS, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)counts, (int32_t*)freq, (int32_t*)cum);
  return (int)cudaGetLastError();
}

// X: x [stride, K] u8, lane_len [K] i32, freqs and cums [n_snap, 256] i32
// (W's) -> ev [stride, K] u32, states [K] u32.
extern "C" int ct_ans2_encode(const void* x, const void* lane_len, const void* freq,
                              const void* cum, void* ev, void* states, int K, int stride, int r,
                              void* stream) {
  if (K < 1 || K > 65536 || (K & (K - 1)) || stride < 0 || r < 0 || r > 31)
    return (int)cudaErrorInvalidValue;
  ans2_encode_kernel<<<(K + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, (const int32_t*)lane_len, (const int32_t*)freq, (const int32_t*)cum,
      (uint32_t*)ev, (uint32_t*)states, K, stride, r);
  return (int)cudaGetLastError();
}
