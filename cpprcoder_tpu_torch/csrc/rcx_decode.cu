// Kernel C: CT-RCX decode on Hopper.
//
// Replaces the Pallas kernel cpprcoder_tpu/ops/rcx_pallas.py:374
// `_decode_kernel` (pallas_call at rcx_pallas.py:485).
//
// What it computes: the inverse of kernel A, per chunked lane; each symbol
// goes straight to out[lane * stride + j], the chunked layout of the
// original bytes.
//
// Design and what bounds it: rc_decode.cuh, whose kernel this file
// instantiates with RESCALE_ROUNDS = 3 and chunked output, one CTA a stream
// below ct::CLUSTER_MIN_K lanes and a cluster of ct::CLUSTER_CTAS from there on
// (kernel E is the same kernel with one context, a requant every step, one
// halving and interleaved output).
#include "rc_decode.cuh"

// Bytes of the global model scratch ct_rcx_decode needs for K lanes at
// cbits (0: none): a lone block's model that shared memory cannot hold. A
// cluster's blocks hold a quarter of the counts each, which always fits.
extern "C" int ct_rcx_decode_scratch(int K, int cbits) {
  return K < ct::CLUSTER_MIN_K ? (int)ct::scratch_bytes(1 << cbits) : 0;
}

// words [streams, l4, K] u32 big-endian word rows; lane_len [streams, K]
// i32; out [streams, K*stride] u8; gmodel: ct_rcx_decode_scratch bytes a
// stream, or null when that is 0. Below CLUSTER_MIN_K lanes a block a
// stream (one lane a thread); from there on a cluster a stream, 1, 2, 4 or
// 8 lanes a thread (K <= 32768). Returns the cudaError_t as an int
// (cudaErrorInvalidValue when K is too large).
extern "C" int ct_rcx_decode(const void* words, const void* lane_len, void* out, void* gmodel,
                             int streams, int K, int l4, int stride, int inc, uint32_t climit,
                             int cbits, int wlog, void* stream) {
  constexpr int R = ct::RESCALE_ROUNDS, G = ct::CLUSTER_CTAS;
  LaunchFn fn = nullptr;
  if (K < ct::CLUSTER_MIN_K) {
    fn = gmodel ? launch_kernel<1, R, false, true, 1> : launch_kernel<1, R, false, false, 1>;
  } else {
    switch (ct::lanes_per_thread((K + G - 1) / G)) {
      case 1: fn = launch_kernel<1, R, false, false, G>; break;
      case 2: fn = launch_kernel<2, R, false, false, G>; break;
      case 4: fn = launch_kernel<4, R, false, false, G>; break;
      case 8: fn = launch_kernel<8, R, false, false, G>; break;
    }
  }
  if (!fn) return (int)cudaErrorInvalidValue;
  return (int)fn(words, lane_len, out, gmodel, streams, K, l4, stride, inc, climit, cbits, wlog,
                 (cudaStream_t)stream);
}
