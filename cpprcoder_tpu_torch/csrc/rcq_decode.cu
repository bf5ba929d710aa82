// Kernel E: CT-RCQ decode on Hopper.
//
// Replaces the Pallas kernel cpprcoder_tpu/ops/rcq_pallas.py:151
// `_decode_kernel` (pallas_call at rcq_pallas.py:252).
//
// What it computes: the inverse of kernel D. Per interleaved lane, refill
// from the lane's big-endian u32 word row; the symbol is the largest s with
// cum[s] * t <= code (rcq_ref.rcq_decode's searchsorted(side="right") - 1);
// the one shared model C[256] takes the same update, single-halving
// rescale and requant before every step as the encoder.
//
// Design: kernel C's kernel (rc_decode.cuh) instantiated with ROUNDS = 1
// and interleaved output (lane i's step-j byte to out[j*K + i], K
// consecutive bytes a step across the block), run with cbits = 0 and
// wlog = 0. The two-level 16x16 one-hot search of the Pallas kernel
// becomes an 8-step binary search over cum[0..256] in shared memory.
//
// What bounds it: as kernel D, the sequential steps on one SM and the
// one-warp requant between two __syncthreads at every step.
#include "rc_decode.cuh"

// words [l4, K] u32 big-endian word rows; lane_len [K] i32; out [K*stride] u8.
extern "C" int ct_rcq_decode(const void* words, const void* lane_len, void* out, int K, int l4,
                             int stride, int inc, int climit, void* stream) {
  return rc_decode<1, true>(words, lane_len, out, nullptr, 1, K, l4, stride, inc, climit, 0, 0,
                            stream);
}
