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
// instantiates with RESCALE_ROUNDS = 3 (kernel D is the same kernel's
// one-row instantiation, with a requant every step and one halving).
#include "rc_encode.cuh"

// Bytes of the global model scratch ct_rcx_encode needs a stream at cbits
// (0: none, the model fits shared memory).
extern "C" int ct_rcx_encode_scratch(int cbits) { return (int)ct::scratch_bytes(1 << cbits); }

// gmodel: ct_rcx_encode_scratch bytes a stream, or null when that is 0.
extern "C" int ct_rcx_encode(const void* x, const void* lane_len, void* ev, void* gmodel,
                             int streams, int K, int stride, int inc, int climit, int cbits,
                             int wlog, void* stream) {
  return rc_encode<ct::RESCALE_ROUNDS, false>(x, lane_len, ev, gmodel, streams, K, stride, inc,
                                              climit, cbits, wlog, stream);
}
