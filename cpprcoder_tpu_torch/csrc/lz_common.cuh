// Pieces shared by the CT-LZ4 kernels (lz_encode.cu, lz_decode.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ct {

// Bytes sh .. sh + 15 of a followed by b.
__device__ __forceinline__ uint4 shift16(uint4 a, uint4 b, int sh) {
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int r = 8 * (sh & 3);
  uint32_t o[4];
  switch (sh >> 2) {
    case 0:
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i] = __funnelshift_r(w[i], w[i + 1], r);
      break;
    case 1:
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i] = __funnelshift_r(w[i + 1], w[i + 2], r);
      break;
    case 2:
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i] = __funnelshift_r(w[i + 2], w[i + 3], r);
      break;
    default:
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i] = __funnelshift_r(w[i + 3], w[i + 4], r);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// The CTA copies src[0..size) to dst (shared memory, 16-byte aligned): 16
// bytes of dst a store, from the two aligned 16-byte loads around them,
// several in flight a thread; not one dependent load a byte. (The second
// load may read past src + size within the last aligned 16 bytes.)
__device__ inline void stage(uint8_t* __restrict__ dst, const uint8_t* __restrict__ src,
                             int size) {
  const int sh = (int)((uintptr_t)src & 15);
  const uint4* s4 = reinterpret_cast<const uint4*>(src - sh);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  const int full = size / 16;
#pragma unroll 4
  for (int i = threadIdx.x; i < full; i += blockDim.x)
    d4[i] = sh ? shift16(s4[i], s4[i + 1], sh) : s4[i];
  for (int i = full * 16 + threadIdx.x; i < size; i += blockDim.x) dst[i] = src[i];
}

}  // namespace ct
