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
// instantiates with RESCALE_ROUNDS = 3 and chunked output (kernel E is the
// same kernel with one context, a requant every step, one halving and
// interleaved output).
#include "rc_decode.cuh"

extern "C" int ct_rcx_decode(const void* words, const void* lane_len, void* out, void* gmodel,
                             int streams, int K, int l4, int stride, int inc, int climit,
                             int cbits, int wlog, void* stream) {
  return rc_decode<ct::RESCALE_ROUNDS, false>(words, lane_len, out, gmodel, streams, K, l4, stride,
                                              inc, climit, cbits, wlog, stream);
}
