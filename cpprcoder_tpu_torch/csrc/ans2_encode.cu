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
// W (second round; the first was a memset, then the histograms added to a
// window's row by global atomics, the walk one CTA of 256 threads reading
// each window's row from global memory on its chain, and the normalize a
// CTA a window counting ranks by 256 shared reads a thread). Three
// launches, each after the last by programmatic dependent launch (a
// kernel's prologue under the last one's tail, griddepcontrol.wait before
// it reads what the last wrote):
//   hist  a CTA a (window, tile of TILE positions): 16-byte loads, each
//         thread's bytes counted as runs into its warp's own histogram in
//         shared memory (a run of one byte is one atomic, not one a byte),
//         then the CTA's row written whole to part[w][tile]: no memset, no
//         global atomic; a window of at most `rows` tiles (`rows` = the
//         longest window's tiles, at most MAX_ROWS) has that many rows;
//   walk  one CTA, a thread a symbol: the windows' rows staged into shared
//         memory by cp.async.bulk on two mbarriers, WALK_CHUNK bytes a
//         chunk, the next chunk landing while this one is walked, so no
//         global load sits on the walk's chain; at a chunk's start each
//         window's step of the total (inc times its coded positions) formed
//         a thread a window. A window is then a handful of instructions:
//         the rescale where the total has reached the limit (its new total
//         from two counting barriers, (total - #odd) / 2 + #even halves, no
//         sum of the counts), the counts stored (nothing waits on the
//         stores), the window's rows added (unrolled for 1, 2 and 4 rows);
//   norm  a warp a window (NORM_WINDOWS a CTA): ans2_model.cuh's
//         warp_normalize, exact to normalize_freqs by a sort of packed unique
//         keys, -> entries [n_snap, 256] (rcp, f | c << 16), the form X
//         stages, rcp = floor((2^32 - 1) / f); they hold the table's (f, c)
//         exactly, so W writes no other table.
// Measured and left out (PERF.md, section 6; variants in
// compare_kernels.py): the normalize as the rank loops (norm_rank: slower at
// all twelve shapes timed), the launches without programmatic dependent
// launch (w_nopdl: ~2 µs slower at each), the walk folded into the
// histogram launch (w_fold), the walk on one warp with 8 counts a lane
// and the walk forming each window's total step on its chain (each ~0.25
// µs a window: its ~130 instructions latency-bound). W's registers: hist
// 32, walk 25-28, norm 63; no spill.
// X (second round; the first read every step's entry from global memory
// and divided for its reciprocal a step): kernel F's coder
// (csrc/rans_encode.cu), a thread a lane in CTAs of 128, walking the lane's
// steps backwards; step t codes with table snapshot_index(t). Lane lengths
// differ by at most one, so every lane of a CTA crosses a window edge at
// the same step: the CTA stages the current window's entries (W's) in
// shared memory, the next window's loaded during the current one, one
// barrier a window. From step 16 on, where windows are 16 steps or more
// (refresh_log2 >= 4), the steps run as F's: runs of 16, a run's bytes
// loaded during the run before, its entries read from the staged table at
// its start, the step F's (`encode_step`, its exactness argument there and
// in tests/test_torch_rans_divide.py). The first 16 steps, and every step
// at refresh_log2 < 4, read their entries from global memory a run ahead:
// one 8-byte load an entry, no divide. Measured and left out (PERF.md,
// section 6): CTAs of 32 lanes (slower wherever tables are staged), windows
// of 8 steps staged in runs of 8 (a barrier every run: slower than global
// reads at K = 2,048). Events ev[t, j] are (emit << 16) | (st & 0xFFFF)
// before the step, 0 where the lane is inactive.
//
// What bounds them: W moves n bytes and writes 8 bytes a table cell (the
// entry: a few microseconds of memory time at kennedy.xls); it is three
// launches' fixed cost (~3-5 µs together under PDL), the walk's chain of
// windows (~0.03 µs a window, more where a rescale's two barriers fire)
// and a normalize's sort (a few microseconds, all windows at once). X,
// like F, is bound by each lane's chain of about 6 dependent integer
// operations a step, and a barrier a window; K = 2 lanes over 1,861 steps
// (grammar.lsp) fill one warp of one SM. X's registers: 125, no spill.
#include <cstdint>
#include <cuda_runtime.h>

#include "ans2_model.cuh"

namespace {

using namespace ans2;

constexpr int HIST_THREADS = 256;
constexpr int HIST_WARPS = HIST_THREADS / 32;
constexpr int TILE = 4096;           // positions a histogram CTA (ans2_kernels.TILE)
constexpr int MAX_ROWS = 32;         // a window's histogram rows at most (ans2_kernels.MAX_ROWS)
constexpr int WALK_THREADS = 256;    // the walk: a thread a symbol
constexpr int WALK_CHUNK = 32768;    // bytes of rows the walk stages a chunk
constexpr int NORM_WINDOWS = 4;      // windows a norm CTA, a warp each
constexpr int NORM_CTA = 32 * NORM_WINDOWS;
constexpr int THREADS = 128;  // X: lanes a CTA
constexpr int AHEAD = 16;     // X: steps a run
constexpr int STAGE_LOG2 = 4; // X: windows of 2^4 = AHEAD steps and more are staged
constexpr int NS = 256 / THREADS;  // X: table entries a thread stages

// Programmatic dependent launch: wait until the grid before has completed
// and its writes are visible (a no-op in a grid launched without it), and
// let the grid after launch now.
__device__ __forceinline__ void griddep_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }
__device__ __forceinline__ void griddep_launch() { asm volatile("griddepcontrol.launch_dependents;"); }

// Byte b into the thread's run; a run of another byte goes to h first.
__device__ __forceinline__ void run_add(uint32_t* h, uint32_t b, uint32_t& prev, uint32_t& run) {
  if (b != prev) {
    if (run) atomicAdd(h + prev, run);
    prev = b;
    run = 1;
  } else {
    ++run;
  }
}

__device__ __forceinline__ void runs_of_word(uint32_t* h, uint32_t v, uint32_t& prev,
                                             uint32_t& run) {
#pragma unroll
  for (int b = 0; b < 4; ++b) run_add(h, (v >> (8 * b)) & 0xFFu, prev, run);
}

// x [steps*K] u8 -> part [n_snap][rows][256] u32: CTA (w, y) the histogram
// of tiles y, y + rows, ... of window w (a zero row where there are none).
__global__ void __launch_bounds__(HIST_THREADS)
    ans2_hist_kernel(const uint8_t* __restrict__ x, uint32_t* __restrict__ part, long long n,
                     int K, int steps, int r, int rows) {
  __shared__ __align__(16) uint32_t hs[HIST_WARPS][256];
  griddep_launch();
  const int tid = threadIdx.x;
  const unsigned long long w = blockIdx.x;
  unsigned long long b = window_start(w + 1, r);
  if (b > (unsigned long long)steps) b = steps;
  const unsigned long long end = b * K < (unsigned long long)n ? b * K : (unsigned long long)n;
  for (int i = tid; i < HIST_WARPS * 256; i += HIST_THREADS) (&hs[0][0])[i] = 0;
  __syncthreads();
  uint32_t* const h = hs[tid >> 5];
  uint32_t prev = 0, run = 0;
  for (unsigned long long lo = window_start(w, r) * K + (unsigned long long)blockIdx.y * TILE;
       lo < end; lo += (unsigned long long)rows * TILE) {
    const unsigned long long len = end - lo < (unsigned long long)TILE ? end - lo : TILE;
    // the bytes before the first 16-byte boundary and past the last one
    unsigned long long head = (16 - ((uintptr_t)(x + lo) & 15)) & 15;
    head = head < len ? head : len;
    const unsigned long long nv = (len - head) / 16, tail = len - head - 16 * nv;
    if ((unsigned long long)tid < head) run_add(h, x[lo + tid], prev, run);
    if ((unsigned long long)tid < tail) run_add(h, x[lo + head + 16 * nv + tid], prev, run);
    const uint4* v = reinterpret_cast<const uint4*>(x + lo + head);
    for (unsigned long long i = tid; i < nv; i += 4 * HIST_THREADS) {
      uint4 q[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        q[u] = i + u * HIST_THREADS < nv ? __ldg(v + i + u * HIST_THREADS) : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (i + u * HIST_THREADS < nv) {
          runs_of_word(h, q[u].x, prev, run);
          runs_of_word(h, q[u].y, prev, run);
          runs_of_word(h, q[u].z, prev, run);
          runs_of_word(h, q[u].w, prev, run);
        }
      }
    }
  }
  if (run) atomicAdd(h + prev, run);
  __syncthreads();
  uint32_t sum = 0;
#pragma unroll
  for (int i = 0; i < HIST_WARPS; ++i) sum += hs[i][tid];
  part[(w * rows + blockIdx.y) * 256 + tid] = sum;
}

// A window's histogram: the sum of its `rows` rows (ROWS of them where
// ROWS > 0, unrolled).
template <int ROWS>
__device__ __forceinline__ uint32_t row_sum(const uint32_t* hw, int rows) {
  uint32_t h = 0;
  if (ROWS > 0) {
#pragma unroll
    for (int y = 0; y < ROWS; ++y) h += hw[y * 256];
  } else {
    for (int y = 0; y < rows; ++y) h += hw[y * 256];
  }
  return h;
}

// part [n_snap][rows][256] u32 -> counts [n_snap, 256] u64: the counts each
// window's table is normalized from, after its rescale. A thread a symbol;
// the rows staged by bulk copies into two buffers of `per` windows, and at
// each chunk's start the steps of the chunk's totals, inc times each
// window's coded positions, formed a thread a window. A window is then a
// handful of instructions and no barrier, but where a rescale fires: two
// counting barriers (the new total is (total - #odd) / 2 + #even halves).
template <int ROWS>
__global__ void __launch_bounds__(WALK_THREADS)
    ans2_walk_kernel(const uint32_t* __restrict__ part, unsigned long long* __restrict__ counts,
                     long long n, int K, int steps, int r, int n_snap, int rows, uint32_t inc,
                     int limit_log2) {
  extern __shared__ __align__(128) uint32_t buf[];
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ unsigned long long tadd[WALK_CHUNK / 1024];
  const int s = threadIdx.x;
  const int per = WALK_CHUNK / (1024 * rows) > 0 ? WALK_CHUNK / (1024 * rows) : 1;
  const int n_chunks = (n_snap + per - 1) / per;
  const uint32_t chunk_words = (uint32_t)per * rows * 256;
  if (s == 0) {
    mbar_init(bar);
    mbar_init(bar + 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  griddep_wait();
  griddep_launch();
  // thread 0: chunk c's windows' rows into buffer c & 1
  const auto stage = [&](int c) {
    const int w0 = c * per, nw = n_snap - w0 < per ? n_snap - w0 : per;
    bulk_copy(buf + (c & 1) * chunk_words, part + (size_t)w0 * rows * 256,
              (uint32_t)nw * rows * 1024, bar + (c & 1));
  };
  if (s == 0) {
    stage(0);
    if (n_chunks > 1) stage(1);
  }
  const bool can_rescale = limit_log2 < 64;
  const unsigned long long limit = can_rescale ? 1ull << limit_log2 : 0;
  unsigned long long cnt = 1, total = 256;
  unsigned long long* out = counts + s;
  for (int c = 0; c < n_chunks; ++c) {
    const int w0 = c * per, nw = n_snap - w0 < per ? n_snap - w0 : per;
    if (s < nw) {
      unsigned long long e = window_start(w0 + s + 1, r);
      if (e > (unsigned long long)steps) e = steps;
      tadd[s] = (unsigned long long)inc * coded(window_start(w0 + s, r), e, n, K);
    }
    mbar_wait(bar + (c & 1), (uint32_t)(c >> 1) & 1u);
    __syncthreads();
    const uint32_t* hw = buf + (c & 1) * chunk_words + s;
    for (int i = 0; i < nw; ++i) {
      if (can_rescale && total >= limit) {
        const unsigned long long h = cnt >> 1;
        const int odd = __syncthreads_count((int)(cnt & 1));
        const int even_half = __syncthreads_count((int)(~h & 1));
        cnt = h | 1;
        total = (total - odd) / 2 + even_half;
      }
      *out = cnt;
      out += 256;
      cnt += (unsigned long long)inc * row_sum<ROWS>(hw, rows);
      hw += rows * 256;
      total += tadd[i];
    }
    // every thread is done with buffer c & 1 and with tadd: chunk c + 2 may
    // land in the buffer
    __syncthreads();
    if (s == 0 && c + 2 < n_chunks) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      stage(c + 2);
    }
  }
}

// Table entry (rcp, f | c << 16), rcp = floor((2^32 - 1) / f) (0 for f =
// 0, a symbol that is never coded): the form X reads.
__device__ __forceinline__ uint2 make_entry(uint32_t f, uint32_t c) {
  return make_uint2(f ? 0xFFFFFFFFu / f : 0u, f | (c << 16));
}

// counts [B, 256] u64 -> entries [B, 256] (uint2). A warp a row,
// NORM_WINDOWS rows a CTA.
__global__ void __launch_bounds__(NORM_CTA)
    ans2_norm_kernel(const unsigned long long* __restrict__ counts, uint2* __restrict__ entries,
                     int B) {
  griddep_wait();
  const int w = blockIdx.x * NORM_WINDOWS + (threadIdx.x >> 5);
  if (w >= B) return;
  const size_t at = (size_t)w * 256 + PER_LANE * (threadIdx.x & 31);
  unsigned long long c8[PER_LANE];
  const ulonglong2* src = reinterpret_cast<const ulonglong2*>(counts + at);
#pragma unroll
  for (int i = 0; i < PER_LANE / 2; ++i) {
    const ulonglong2 v = src[i];
    c8[2 * i] = v.x, c8[2 * i + 1] = v.y;
  }
  uint32_t f[PER_LANE], c[PER_LANE];
  warp_normalize(c8, f, c);
  uint4* eo = reinterpret_cast<uint4*>(entries + at);
#pragma unroll
  for (int i = 0; i < PER_LANE / 2; ++i) {
    const uint2 a = make_entry(f[2 * i], c[2 * i]), b = make_entry(f[2 * i + 1], c[2 * i + 1]);
    eo[i] = make_uint4(a.x, a.y, b.x, b.y);
  }
}

// Symbol s's entry in table w, from global memory.
__device__ __forceinline__ uint2 entry(const uint2* __restrict__ entries, uint32_t w, uint32_t s) {
  return __ldg(entries + (size_t)w * 256 + s);
}

// Table w's entries of symbols threadIdx.x + i * THREADS, into registers.
__device__ __forceinline__ void stage_load(const uint2* __restrict__ entries, uint32_t w,
                                           uint2 (&e)[NS]) {
  const size_t row = (size_t)w * 256 + threadIdx.x;
#pragma unroll
  for (int i = 0; i < NS; ++i) e[i] = __ldg(entries + row + i * THREADS);
}

// Their entries into a table in shared memory.
__device__ __forceinline__ void stage_store(uint2* tab, const uint2 (&e)[NS]) {
#pragma unroll
  for (int i = 0; i < NS; ++i) tab[threadIdx.x + i * THREADS] = e[i];
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

// x [stride, K] u8; lane_len [K] i32; entries [n_snap, 256] (W's);
// ev [stride, K] u32; states [K] u32. Lane lengths differ by at most one,
// so every lane of a CTA crosses a window edge at the same step.
__global__ void __launch_bounds__(THREADS)
    ans2_encode_kernel(const uint8_t* __restrict__ x, const int32_t* __restrict__ lane_len,
                       const uint2* __restrict__ entries, uint32_t* __restrict__ ev,
                       uint32_t* __restrict__ states, int K, int stride, int r) {
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
    uint2 pe[NS];
    stage_load(entries, w, pe);
    stage_store(tabs[w & 1], pe);
    __syncthreads();
    unsigned long long edge = window_start(w, r);  // window w's first step
    if (edge > (unsigned long long)t0) stage_load(entries, w - 1, pe);
    const int m0 = t0 / AHEAD;
    int m = (stride - 1) / AHEAD;  // the top run, steps [AHEAD*m, stride)
    for (int t = len - 1; t >= AHEAD * m; --t)
      el[(size_t)t * K] = encode_step(st, tabs[w & 1][xl[(size_t)t * K]]);
    uint32_t nx[AHEAD];
    for (;;) {
      if ((unsigned long long)(AHEAD * m) == edge && m > m0) {
        stage_store(tabs[(w - 1) & 1], pe);
        __syncthreads();
        edge = window_start(--w, r);
        if (edge > (unsigned long long)t0) stage_load(entries, w - 1, pe);
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
    el[(size_t)j * K] = encode_step(st, entry(entries, snapshot_index(j, r), xl[(size_t)j * K]));
  if (j >= 0) {
    uint32_t nx[AHEAD];
    uint2 tn[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) nx[u] = xl[(size_t)(j - u) * K];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) tn[u] = entry(entries, snapshot_index(j - u, r), nx[u]);
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
          tn[u] = entry(entries, snapshot_index(j - AHEAD - u, r), nx[u]);
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

// A kernel after the last on the stream, by programmatic dependent launch.
template <class... Params, class... Args>
cudaError_t launch_after(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                         cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, (Params)args...);
}

}  // namespace

// W: x [steps, K] u8 (zero past n) -> entries [n_snap, 256] (uint2: rcp,
// f | c << 16). scratch: counts
// [n_snap, 256] u64, then part [n_snap][rows][256] u32 (rows: the longest
// window's TILE tiles, at most MAX_ROWS; ans2_kernels.model_scratch). r is
// the effective refresh_log2 (at most 31: ans2_ops.refresh_eff), limit_log2
// at most 63 (no total reaches 2^63).
extern "C" int ct_ans2_model(const void* x, void* scratch, void* entries, long long n, int K,
                             int steps, int inc, int limit_log2, int r, int n_snap, int rows,
                             void* stream) {
  if (K < 1 || K > 65536 || (K & (K - 1)) || steps < 1 || r < 0 || r > 31 || n < 1 ||
      n > (long long)K * steps || n <= (long long)K * (steps - 1) || n_snap < 1 || inc < 0 ||
      inc > 255 || limit_log2 < 0 || limit_log2 > 63 || rows < 1 || rows > MAX_ROWS ||
      ((uintptr_t)scratch & 15))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* counts = (unsigned long long*)scratch;
  uint32_t* part = (uint32_t*)(counts + (size_t)n_snap * 256);
  ans2_hist_kernel<<<dim3(n_snap, rows), HIST_THREADS, 0, s>>>((const uint8_t*)x, part, n, K,
                                                               steps, r, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int per = WALK_CHUNK / (1024 * rows) > 0 ? WALK_CHUNK / (1024 * rows) : 1;
  const int smem = 2 * per * rows * 1024;
  const auto walk = rows == 1   ? ans2_walk_kernel<1>
                    : rows == 2 ? ans2_walk_kernel<2>
                    : rows == 4 ? ans2_walk_kernel<4>
                                : ans2_walk_kernel<0>;
  e = cudaFuncSetAttribute(walk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = launch_after(walk, dim3(1), dim3(WALK_THREADS), smem, s, (const uint32_t*)part, counts, n,
                     K, steps, r, n_snap, rows, (uint32_t)inc, limit_log2);
  if (e == cudaSuccess)
    e = launch_after(ans2_norm_kernel, dim3((n_snap + NORM_WINDOWS - 1) / NORM_WINDOWS),
                     dim3(NORM_CTA), 0, s, (const unsigned long long*)counts, (uint2*)entries,
                     n_snap);
  return (int)e;
}

// The normalize alone: counts [B, 256] u64 -> entries [B, 256] (uint2).
extern "C" int ct_ans2_normalize(const void* counts, void* entries, int B, void* stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  ans2_norm_kernel<<<(B + NORM_WINDOWS - 1) / NORM_WINDOWS, NORM_CTA, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)counts, (uint2*)entries, B);
  return (int)cudaGetLastError();
}

// X: x [stride, K] u8, lane_len [K] i32, entries [n_snap, 256] (W's) -> ev
// [stride, K] u32, states [K] u32.
extern "C" int ct_ans2_encode(const void* x, const void* lane_len, const void* entries, void* ev,
                              void* states, int K, int stride, int r, void* stream) {
  if (K < 1 || K > 65536 || (K & (K - 1)) || stride < 0 || r < 0 || r > 31)
    return (int)cudaErrorInvalidValue;
  ans2_encode_kernel<<<(K + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, (const int32_t*)lane_len, (const uint2*)entries, (uint32_t*)ev,
      (uint32_t*)states, K, stride, r);
  return (int)cudaGetLastError();
}
