// Kernels M and N: CT-MTF1 move-to-front encode (M) and decode (N), plain
// MTF and the reference's MTF-1, on Hopper.
//
// They replace no Pallas kernel: the JAX package runs MTF as one compiled
// lax.scan over the 2^15 steps of a block, batched over blocks
// (cpprcoder_tpu/ops/mtf_ops.py:45-81; semantics in reference/mtf_ref.py:
// 20-58, the reference's blksort.h:663-793).
//
// What they compute, per 2^15-byte block (independent, initial list the
// identity, prev = 1): encode emits each byte's position r in the list and
// decode the list's entry at the given r; then the entry at r moves to dst:
//   - MTF: dst = 0 (when r > 0);
//   - MTF-1: dst = 1 when r > 1; when r == 1, dst = 0 only if the previous
//     rank was not 0 (a swap of the first two), else no move;
// the entries at dst..r-1 move up by one. The last block is cut at n.
//
// Design: one warp a block (a CTA of 32 threads); the 256-entry list is in
// the warp's registers, 8 entries a lane in one u64 (lane l holds positions
// 8l..8l+7, the lowest in the low byte), so the list costs no shared memory
// and a step no barrier. Encode finds r by a zero-byte test of the lane's
// word against the symbol and a warp ballot; decode reads entry r with one
// shuffle. A move shifts the entries in (dst, r] by one byte, each lane
// taking the byte below its word from the lane before (one shuffle). The
// warp reads its input 128 bytes at a time (a u32 a lane), hands each step
// its byte by a shuffle, and collects 128 output bytes the same way before
// one coalesced store.
//
// What bounds it: a block's steps are sequential, each a chain of about
// four shuffles and a dozen integer operations; 32 blocks a MiB keep 32 of
// the 132 SMs busy with one warp each. Latency-bound.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 1 << 15;     // MTF_BLOCK
constexpr int CHUNK = 128;         // bytes the warp loads and stores at once
constexpr uint32_t FULL = 0xFFFFFFFFu;
constexpr uint64_t ONES = 0x0101010101010101ull;
constexpr uint64_t HIGHS = 0x8080808080808080ull;

// The list after moving sym from position r to position dst (dst < r).
__device__ __forceinline__ uint64_t move_entry(uint64_t tab, int lane, uint32_t sym, int dst,
                                               int r) {
  const uint64_t below = __shfl_up_sync(FULL, tab, 1);
  const uint64_t shifted = (tab << 8) | (lane ? below >> 56 : 0ull);
  const int lo = lane * 8;
  const int a = max(dst + 1 - lo, 0), b = min(r - lo, 7);  // bytes a..b take their neighbour's
  if (a <= b) {
    const uint64_t m = (b - a == 7 ? ~0ull : (1ull << (8 * (b - a + 1))) - 1) << (8 * a);
    tab = (tab & ~m) | (shifted & m);
  }
  if (dst >= lo && dst < lo + 8) {
    const int sh = 8 * (dst - lo);
    tab = (tab & ~(0xFFull << sh)) | ((uint64_t)sym << sh);
  }
  return tab;
}

// in, out [nb * BLOCK] u8 (in zero-padded past n); block b of the grid runs
// list block b.
template <bool DECODE, bool MTF1>
__global__ void __launch_bounds__(32) mtf_kernel(const uint8_t* __restrict__ in,
                                                 uint8_t* __restrict__ out, long long n) {
  const int lane = threadIdx.x;
  const long long base = (long long)blockIdx.x * BLOCK;
  const long long left = n - base;
  const int valid = left < BLOCK ? (int)left : BLOCK;
  uint64_t tab = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) tab |= (uint64_t)(lane * 8 + i) << (8 * i);
  int prev = 1;
  const uint32_t* in4 = reinterpret_cast<const uint32_t*>(in + base);
  uint32_t* out4 = reinterpret_cast<uint32_t*>(out + base);
  for (int c = 0; c < valid; c += CHUNK) {
    const uint32_t word = in4[c / 4 + lane];
    uint32_t o = 0;
    const int steps = valid - c < CHUNK ? valid - c : CHUNK;
    for (int k = 0; k < steps; ++k) {
      const uint32_t v = (__shfl_sync(FULL, word, k >> 2) >> (8 * (k & 3))) & 0xFFu;
      uint32_t sym;
      int r;
      if (DECODE) {
        r = (int)v;
        sym = (uint32_t)(__shfl_sync(FULL, tab, r >> 3) >> (8 * (r & 7))) & 0xFFu;
      } else {
        sym = v;
        const uint64_t xo = tab ^ (sym * ONES);
        const uint64_t z = (xo - ONES) & ~xo & HIGHS;  // the lowest flag is exact
        const int src = __ffs(__ballot_sync(FULL, z != 0)) - 1;
        const int byte = z ? (__ffsll((long long)z) - 1) >> 3 : 0;
        r = src * 8 + __shfl_sync(FULL, byte, src);
      }
      const int dst = MTF1 ? (r > 1 ? 1 : (r == 1 && prev != 0 ? 0 : r)) : (r > 0 ? 0 : r);
      if (dst < r) tab = move_entry(tab, lane, sym, dst, r);
      prev = r;
      if (lane == (k >> 2)) o |= (DECODE ? sym : (uint32_t)r) << (8 * (k & 3));
    }
    out4[c / 4 + lane] = o;
  }
}

template <bool DECODE, bool MTF1>
cudaError_t launch(const void* in, void* out, long long n, int nb, cudaStream_t stream) {
  mtf_kernel<DECODE, MTF1><<<nb, 32, 0, stream>>>((const uint8_t*)in, (uint8_t*)out, n);
  return cudaGetLastError();
}

cudaError_t run(bool decode, const void* in, void* out, long long n, int nb, int mtf1,
                cudaStream_t stream) {
  if (n < 1 || nb != (int)((n + BLOCK - 1) / BLOCK)) return cudaErrorInvalidValue;
  if (decode) return mtf1 ? launch<true, true>(in, out, n, nb, stream)
                          : launch<true, false>(in, out, n, nb, stream);
  return mtf1 ? launch<false, true>(in, out, n, nb, stream)
              : launch<false, false>(in, out, n, nb, stream);
}

}  // namespace

// x [nb * 2^15] u8 zero-padded past n -> ranks [nb * 2^15] u8 (the first n
// meaningful); nb = ceil(n / 2^15). Returns the cudaError_t as an int.
extern "C" int ct_mtf_encode(const void* x, void* ranks, long long n, int nb, int mtf1,
                             void* stream) {
  return (int)run(false, x, ranks, n, nb, mtf1, (cudaStream_t)stream);
}

// ranks [nb * 2^15] u8 zero-padded past n -> bytes [nb * 2^15] u8.
extern "C" int ct_mtf_decode(const void* ranks, void* out, long long n, int nb, int mtf1,
                             void* stream) {
  return (int)run(true, ranks, out, n, nb, mtf1, (cudaStream_t)stream);
}
