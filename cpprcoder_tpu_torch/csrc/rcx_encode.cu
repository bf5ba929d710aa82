// Kernel A: CT-RCX encode on Hopper.
//
// Replaces the Pallas kernel cpprcoder_tpu/ops/rcx_pallas.py:163
// `_encode_kernel` (pallas_call at rcx_pallas.py:256).
//
// What it computes: for each of K chunked lanes (lane i codes bytes
// x[i*stride + j], j < lane_len[i]), an order-1 context range coder whose
// count model C[2^cbits, 256] is shared by all lanes of the stream and
// requantized every 2^wlog steps with up to 3 halvings; each step emits
// <= 2 packed shift_low events per lane, and 2 flush events end each lane.
//
// Design and what bounds it: rc_encode.cuh, whose kernel this file
// instantiates with RESCALE_ROUNDS = 3, one CTA a stream below
// ct::CLUSTER_MIN_K lanes and a cluster of ct::CLUSTER_CTAS from there on,
// as kernel C (kernel D is the same kernel's one-row instantiation, with a
// requant every step and one halving).
#include "rc_encode.cuh"

// Bytes of the global model scratch ct_rcx_encode needs a stream for K
// lanes at cbits (0: none): a lone block's model that shared memory cannot
// hold. A cluster's blocks hold a quarter of the counts each, which always
// fits.
extern "C" int ct_rcx_encode_scratch(int K, int cbits) {
  return K < ct::CLUSTER_MIN_K ? (int)ct::scratch_bytes(1 << cbits) : 0;
}

// x [streams, stride, K] u8 time-major chunked lanes; lane_len [streams, K]
// i32; ev [streams, 2*stride+2, K] u32; gmodel: ct_rcx_encode_scratch bytes
// a stream, or null when that is 0. Below CLUSTER_MIN_K lanes a block a
// stream (one lane a thread); from there on a cluster a stream, 1, 2, 4 or
// 8 lanes a thread (K <= 32768). Returns the cudaError_t as an int
// (cudaErrorInvalidValue when K is too large).
extern "C" int ct_rcx_encode(const void* x, const void* lane_len, void* ev, void* gmodel,
                             int streams, int K, int stride, int inc, uint32_t climit, int cbits,
                             int wlog, void* stream) {
  constexpr int R = ct::RESCALE_ROUNDS, G = ct::CLUSTER_CTAS;
  EncodeFn fn = nullptr;
  if (K < ct::CLUSTER_MIN_K) {
    fn = gmodel ? launch_encode<1, R, false, 1, true> : launch_encode<1, R, false, 1, false>;
  } else {
    switch (ct::lanes_per_thread((K + G - 1) / G)) {
      case 1: fn = launch_encode<1, R, false, G, false>; break;
      case 2: fn = launch_encode<2, R, false, G, false>; break;
      case 4: fn = launch_encode<4, R, false, G, false>; break;
      case 8: fn = launch_encode<8, R, false, G, false>; break;
    }
  }
  if (!fn) return (int)cudaErrorInvalidValue;
  return (int)fn(x, lane_len, ev, gmodel, streams, K, stride, inc, climit, cbits, wlog,
                 (cudaStream_t)stream);
}
