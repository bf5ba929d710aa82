// Kernel D: CT-RCQ encode on Hopper.
//
// Replaces the Pallas kernel cpprcoder_tpu/ops/rcq_pallas.py:324
// `_encode_kernel` (pallas_call at rcq_pallas.py:399).
//
// What it computes: K interleaved lanes (lane i codes x[j*K + i] at step
// j) code against one order-0 count model C[256] shared by all lanes,
// requantized before every step with a single conditional halving
// (models/qmodel.py: rescale, quantize to a 2^15 total); the coder and its
// packed events are kernel A's.
//
// Design: kernel A's kernel (rc_encode.cuh) instantiated with ROUNDS = 1
// and run with cbits = 0 (one model row of 1.5 KB in shared memory) and
// wlog = 0. The wrapper passes the interleaved [stride, K] grid, so each
// step's loads are K consecutive input bytes.
//
// What bounds it: the steps are sequential on one SM, and every step has a
// __syncthreads-bracketed requant done by one warp (a 256-entry warp scan
// and three shuffle reductions). At small K that warp's latency, not the
// lanes' coding, sets the pace.
#include "rc_encode.cuh"

// x [stride, K] u8 interleaved; lane_len [K] i32; ev [2*stride+2, K] u32.
extern "C" int ct_rcq_encode(const void* x, const void* lane_len, void* ev, int K, int stride,
                             int inc, int climit, void* stream) {
  return rc_encode<1>(x, lane_len, ev, nullptr, 1, K, stride, inc, climit, 0, 0, stream);
}
