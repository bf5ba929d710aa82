// Kernel R: CT-LZ4 (SLZ4) decode, any container (v1 or v2 parse, any
// seg_log2), on Hopper.
//
// It replaces no Pallas kernel: the JAX package decodes with XLA code
// shaped by Mosaic's limits (cpprcoder_tpu/ops/lz_ops.py:756-866,
// `_walk_v2_fn`: token starts found by jump tables and one scan;
// `_resolve_v2_fn`: every output byte's owner by a packed cummax, match
// chains by pointer doubling under a while_loop; the v1 `_walk_fn` and
// `_resolve_fn` below 2^7-byte segments). The spec is the LZ4 block
// decoder reference/slz4_ref.py `decode_block`.
//
// Design: one warp a segment (segments are independent; 4 a CTA). The
// parse is serial, so every lane runs it in step (uniform control flow):
// the warp holds a 128-byte window of the segment's block, 4 bytes a lane,
// and a byte of the parse is a shuffle from it (a read outside the window
// loads the window at that byte, one coalesced load). Literal runs copy 32
// bytes a step, a byte a lane. A match copies 32 bytes a step: with offset
// off >= 32 the step's sources are written by earlier steps; with off < 32
// lane t of every step writes out[d + k] = out[d - off + (k mod off)], whose
// sources lie before d, so every step is independent. __syncwarp orders
// the steps' global writes.
//
// Every read and write is checked, and a segment that fails sets its error
// code (ops/lz_kernels.py ERRORS, in the order the plain version checks):
// a read past the segment's block, a write past its length
// min(s, n - i*s), an offset 0 or before the segment's start, or a decoded
// length that differs. Bound: bytes (the payload read once, the output
// written once). What holds it back: a dependent window load on most
// tokens, and one warp a segment.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;   // segments a CTA
constexpr int MIN_MATCH = 4;
constexpr unsigned FULL = 0xffffffffu;
enum { OK = 0, OFFSET_ZERO = 1, OFFSET_BEFORE = 2, READ_OVERRUN = 3, WRITE_OVERRUN = 4,
       BAD_LENGTH = 5 };

// The warp's 128-byte window over comp[..end): lane l holds bytes base + 4l
// .. base + 4l + 3, zero past end.
struct Window {
  const uint8_t* comp;
  long long end, base;
  uint32_t word;
  int lane;

  __device__ int at(long long p) {
    long long r = p - base;
    if (r < 0 || r >= 128) {
      base = p;
      r = 0;
      word = 0;
      for (int k = 0; k < 4; ++k) {
        const long long q = p + 4 * lane + k;
        if (q < end) word |= (uint32_t)comp[q] << (8 * k);
      }
    }
    const uint32_t v = __shfl_sync(FULL, word, (int)(r >> 2));
    return (v >> (8 * (r & 3))) & 255;
  }
};

// One segment's block comp[pos..pos+size) into o[0..len) -> its code.
__device__ int decode_segment(const uint8_t* __restrict__ comp, long long pos, long long size,
                              uint8_t* o, long long len, int lane) {
  const long long end = pos + size;
  Window win{comp, end, -1000, 0u, lane};
  long long d = 0;
  while (pos < end) {
    const int tok = win.at(pos++);
    long long lit = tok >> 4;
    if (lit == 15) {
      int b;
      do {
        if (pos >= end) return READ_OVERRUN;
        b = win.at(pos++);
        lit += b;
      } while (b == 255);
    }
    if (pos + lit > end) return READ_OVERRUN;
    if (d + lit > len) return WRITE_OVERRUN;
    for (long long k = lane; k < lit; k += 32) o[d + k] = comp[pos + k];
    pos += lit;
    d += lit;
    if (pos >= end) break;
    if (pos + 2 > end) return READ_OVERRUN;
    const int off = win.at(pos) | (win.at(pos + 1) << 8);
    pos += 2;
    if (off == 0) return OFFSET_ZERO;
    long long m = (tok & 15) + MIN_MATCH;
    if ((tok & 15) == 15) {
      int b;
      do {
        if (pos >= end) return READ_OVERRUN;
        b = win.at(pos++);
        m += b;
      } while (b == 255);
    }
    if (d < off) return OFFSET_BEFORE;
    if (d + m > len) return WRITE_OVERRUN;
    __syncwarp();
    uint8_t* dst = o + d;
    const uint8_t* src = dst - off;
    for (long long k0 = 0; k0 < m; k0 += 32) {
      const long long k = k0 + lane;
      if (k < m) dst[k] = src[off < 32 ? k % off : k];
      __syncwarp();
    }
    d += m;
  }
  return d == len ? OK : BAD_LENGTH;
}

__global__ void __launch_bounds__(WARPS * 32)
decode_kernel(const uint8_t* __restrict__ comp, const long long* __restrict__ bases,
              const long long* __restrict__ sizes, uint8_t* out, int32_t* __restrict__ err,
              int n_segs, long long n, long long s) {
  const int seg = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (seg >= n_segs) return;
  const long long d0 = (long long)seg * s;
  const int code = decode_segment(comp, bases[seg], sizes[seg], out + d0, min(s, n - d0), lane);
  if (lane == 0) err[seg] = code;
}

}  // namespace

// comp uint8 [total], bases and sizes int64 [n_segs] -> out uint8 [n]
// (segment i at i * s), err int32 [n_segs].
extern "C" int ct_lz_decode(const void* comp, const void* bases, const void* sizes, void* out,
                            void* err, int n_segs, long long n, long long s, void* stream) {
  decode_kernel<<<(n_segs + WARPS - 1) / WARPS, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)comp, (const long long*)bases, (const long long*)sizes, (uint8_t*)out,
      (int32_t*)err, n_segs, n, s);
  return (int)cudaGetLastError();
}
