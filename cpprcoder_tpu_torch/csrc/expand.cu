// Kernel B: event grid -> per-lane payload bytes, on Hopper.
//
// Replaces the Pallas kernel cpprcoder_tpu/ops/expand_pallas.py:55
// `_kernel` (pallas_call at expand_pallas.py:162, wrapper
// `materialize_rows_pallas`).
//
// What it computes: events are a time-major [E, K] grid of packed u32
// shift_low events (bit 31 emit, 30:23 first byte, 22 carry, 21:0 run
// length). Per lane, each emitting event contributes its first byte and
// then run_len run bytes (0x00 if carry, else 0xFF); the lane's first
// emitted byte (the coder's dummy) is dropped where may_drop is set.
//
// Design: a block takes LANES adjacent lanes, in two passes.
// Pass 1 (expand_count_kernel) counts each lane's payload bytes: the
// block's threads read whole rows of its lanes (64 B a row at 16 lanes),
// each thread summing its lane's counts over every (COUNT_THREADS /
// LANES)-th time step, so a warp's loads are coalesced and many are in
// flight; the partial sums meet in shared memory, the dummy comes off, and
// one atomicMax a block gives the largest lane, from which the host picks
// the row width l2.
// Pass 2 (expand_write_kernel) writes the rows. A warp owns a lane and
// takes its events a tile of T time steps at a time, each thread reading
// two of them in place (a warp's loads fall on rows of the grid that the
// block's other warps read beside it, so L1 serves them); 32 consecutive
// events of the lane at a time, its threads scan their byte counts with
// shuffles and add the lane's running offset; each thread then writes its
// event's first byte (unless it is the dropped dummy) and, if short, its
// run, so a warp's stores fall on neighbouring addresses of the lane's
// row. Runs longer than LONG_RUN bytes (up to 2^22 - 1) are found by
// ballot and written by the whole warp with 16-byte stores, as is the
// row's zero tail [size, l2). The first emit of a lane may lie in any
// tile: a per-lane flag carried across tiles marks it.
//
// What bounds it: bytes, the grid read twice and K * l2 bytes written
// (kennedy.xls: about 8 MB and 2.5 us at 3.35 TB/s). Each pass is one
// launch; between them the host reads the largest lane size back.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t EV_RUN_MASK = (1u << 22) - 1;
constexpr int LANES = 16;           // lanes a block, both passes
constexpr int COUNT_THREADS = 512;
constexpr int WRITE_THREADS = 32 * LANES;  // a warp a lane
constexpr int T = 64;               // time steps a tile: two events a thread of a warp
constexpr uint32_t LONG_RUN = 32;   // longer runs are written by the whole warp
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ bool drops(const uint8_t* may_drop, int drop_all, int lane) {
  return may_drop ? may_drop[lane] != 0 : drop_all != 0;
}

// ev [E, K] u32; may_drop [K] u8 or null (then drop_all for every lane);
// sizes [K] i32; top: the largest lane size (u64), 0 before the launch.
__global__ void __launch_bounds__(COUNT_THREADS) expand_count_kernel(
    const uint32_t* __restrict__ ev, const uint8_t* __restrict__ may_drop, int drop_all,
    int32_t* __restrict__ sizes, unsigned long long* __restrict__ top, int E, int K) {
  constexpr int GROUPS = COUNT_THREADS / LANES;
  __shared__ unsigned long long part[GROUPS][LANES];
  const int l = threadIdx.x % LANES, g = threadIdx.x / LANES;
  const int lane = blockIdx.x * LANES + l;
  unsigned long long total = 0;
  if (lane < K) {
    const uint32_t* col = ev + lane;
#pragma unroll 8
    for (int e = g; e < E; e += GROUPS) {
      const uint32_t v = __ldg(col + (size_t)e * K);
      total += (v >> 31) ? 1u + (v & EV_RUN_MASK) : 0u;
    }
  }
  part[g][l] = total;
  __syncthreads();
  if (g == 0) {
    for (int i = 1; i < GROUPS; ++i) total += part[i][l];
    if (lane < K) {
      if (total > 0 && drops(may_drop, drop_all, lane)) total -= 1;
      sizes[lane] = (int32_t)total;
    }
    part[0][l] = lane < K ? total : 0ull;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long m = 0;
    for (int i = 0; i < LANES; ++i) m = max(m, part[0][i]);
    atomicMax(top, m);
  }
}

// n bytes of value b from p on, by the 32 threads of a warp (t: the thread's
// index in it): single bytes up to a 16-byte boundary and past the last,
// 16-byte stores between.
__device__ __forceinline__ void warp_fill(uint8_t* p, size_t n, uint8_t b, int t) {
  const size_t to16 = (16u - ((uintptr_t)p & 15u)) & 15u;
  const size_t head = n < to16 ? n : to16;
  for (size_t i = t; i < head; i += 32) p[i] = b;
  p += head;
  n -= head;
  const size_t vecs = n >> 4;
  const uint32_t w = b * 0x01010101u;
  const uint4 q = make_uint4(w, w, w, w);
  uint4* pv = reinterpret_cast<uint4*>(p);
  for (size_t i = t; i < vecs; i += 32) pv[i] = q;
  for (size_t i = (vecs << 4) + t; i < n; i += 32) p[i] = b;
}

// rows [K, l2] u8, l2 at least every lane's size (pass 1). Warp w owns
// lane blockIdx.x * LANES + w.
__global__ void __launch_bounds__(WRITE_THREADS) expand_write_kernel(
    const uint32_t* __restrict__ ev, const uint8_t* __restrict__ may_drop, int drop_all,
    uint8_t* __restrict__ rows, int E, int K, int l2) {
  const int t = threadIdx.x & 31;
  const int lane = blockIdx.x * LANES + (threadIdx.x >> 5);
  if (lane >= K) return;  // the whole warp
  const uint32_t* col = ev + lane;
  uint8_t* row = rows + (size_t)lane * l2;
  int pos = 0;                                 // the lane's bytes written so far
  bool pend = drops(may_drop, drop_all, lane);  // its dummy is still to drop
  for (int e0 = 0; e0 < E; e0 += T) {
#pragma unroll
    for (int c = 0; c < T / 32; ++c) {
      const int e = e0 + c * 32 + t;
      const uint32_t v = e < E ? __ldg(col + (size_t)e * K) : 0u;
      const bool emit = (v >> 31) != 0;
      const unsigned m = __ballot_sync(FULL, emit);
      if (m == 0) continue;
      const bool dropped = pend && t == __ffs(m) - 1;
      pend = false;
      const uint32_t run = v & EV_RUN_MASK;
      const int cnt = emit ? 1 + (int)run - (int)dropped : 0;
      int incl = cnt;  // inclusive scan of the 32 events' byte counts
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, d);
        if (t >= d) incl += y;
      }
      int p = pos + incl - cnt;
      const uint8_t rb = (v >> 22) & 1u ? 0x00 : 0xFF;
      if (emit) {
        if (!dropped) row[p++] = (uint8_t)(v >> 23);
        if (run <= LONG_RUN)
          for (uint32_t r = 0; r < run; ++r) row[p + r] = rb;
      }
      for (unsigned lm = __ballot_sync(FULL, emit && run > LONG_RUN); lm; lm &= lm - 1) {
        const int src = __ffs(lm) - 1;
        warp_fill(row + __shfl_sync(FULL, p, src), __shfl_sync(FULL, run, src),
                  (uint8_t)__shfl_sync(FULL, (uint32_t)rb, src), t);
      }
      pos += __shfl_sync(FULL, incl, 31);
    }
  }
  if (pos < l2) warp_fill(row + pos, (size_t)(l2 - pos), 0, t);
}

}  // namespace

extern "C" int ct_expand_count(const void* ev, const void* may_drop, int drop_all, void* sizes,
                               void* top, int E, int K, void* stream) {
  const cudaError_t err =
      cudaMemsetAsync(top, 0, sizeof(unsigned long long), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  expand_count_kernel<<<(K + LANES - 1) / LANES, COUNT_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)ev, (const uint8_t*)may_drop, drop_all, (int32_t*)sizes,
      (unsigned long long*)top, E, K);
  return (int)cudaGetLastError();
}

extern "C" int ct_expand_write(const void* ev, const void* may_drop, int drop_all, void* rows,
                               int E, int K, int l2, void* stream) {
  expand_write_kernel<<<(K + LANES - 1) / LANES, WRITE_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)ev, (const uint8_t*)may_drop, drop_all, (uint8_t*)rows, E, K, l2);
  return (int)cudaGetLastError();
}

extern "C" const char* ct_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
