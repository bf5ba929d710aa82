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
// Design: one thread per lane walks its events in time order, twice.
// Pass 1 (expand_sizes_kernel) counts the lane's payload bytes, so the
// host can choose the row width l2; pass 2 (expand_rows_kernel) writes
// the bytes straight into rows[lane, pos] and zero-fills the row's tail.
// The event reads are coalesced across lanes; there is no cap on E or l2.
//
// What bounds it: memory traffic, 4 B per event read twice plus l2 bytes
// written per lane; the row writes are strided by l2 across a warp.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t EV_RUN_MASK = (1u << 22) - 1;

__global__ void expand_sizes_kernel(const uint32_t* __restrict__ ev,
                                    const uint8_t* __restrict__ may_drop,
                                    int32_t* __restrict__ sizes, int E, int K) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= K) return;
  int64_t total = 0;
  for (int e = 0; e < E; ++e) {
    const uint32_t v = ev[(size_t)e * K + lane];
    if (v >> 31) total += 1 + (v & EV_RUN_MASK);
  }
  if (total > 0 && may_drop[lane]) total -= 1;
  sizes[lane] = (int32_t)total;
}

__global__ void expand_rows_kernel(const uint32_t* __restrict__ ev,
                                   const uint8_t* __restrict__ may_drop,
                                   uint8_t* __restrict__ rows, int E, int K, int l2) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= K) return;
  uint8_t* row = rows + (size_t)lane * l2;
  bool drop = may_drop[lane] != 0;
  int pos = 0;
  for (int e = 0; e < E; ++e) {
    const uint32_t v = ev[(size_t)e * K + lane];
    if (!(v >> 31)) continue;
    if (drop) {
      drop = false;
    } else {
      if (pos < l2) row[pos] = (uint8_t)((v >> 23) & 0xFFu);
      ++pos;
    }
    const uint8_t rb = ((v >> 22) & 1u) ? 0x00 : 0xFF;
    const int run = (int)(v & EV_RUN_MASK);
    for (int r = 0; r < run; ++r, ++pos)
      if (pos < l2) row[pos] = rb;
  }
  for (; pos < l2; ++pos) row[pos] = 0;
}

constexpr int THREADS = 128;

}  // namespace

extern "C" int ct_expand_sizes(const void* ev, const void* may_drop, void* sizes, int E, int K,
                               void* stream) {
  expand_sizes_kernel<<<(K + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)ev, (const uint8_t*)may_drop, (int32_t*)sizes, E, K);
  return (int)cudaGetLastError();
}

extern "C" int ct_expand_rows(const void* ev, const void* may_drop, void* rows, int E, int K,
                              int l2, void* stream) {
  expand_rows_kernel<<<(K + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)ev, (const uint8_t*)may_drop, (uint8_t*)rows, E, K, l2);
  return (int)cudaGetLastError();
}

extern "C" const char* ct_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
