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
// Design: kernel A's kernel (rc_encode.cuh) in its ONE_ROW instantiation,
// with ROUNDS = 1: one model row of 1.5 KB in shared memory, requantized
// before every step by 8 warps, one cell a thread (kernel E's
// ct::requant_cells, the cum row kept sorted for the coder's two reads);
// each lane's next symbol is loaded a step ahead, and the lanes' updates
// go to two sub-histograms that the requant folds in. The wrapper passes
// the interleaved [stride, K] grid, so each step's loads are K consecutive
// input bytes.
//
// Kernel O (ct_rcq_encode_chunk below) is the same kernel run from a saved
// state (RESUME in rc_encode.cuh): it replaces no Pallas kernel but the
// lax.scan of cpprcoder_tpu/codecs/resume.py:44 `_chunk_fn` and its
// `_flush_fn` (:89), for the resumable CT-RCQ encoder; a launch is a chunk
// of steps, and its launch costs what D's costs for that many steps plus
// the state's load and store.
//
// What bounds it: the steps are sequential on one SM, and every step has
// the requant between two barriers (three named-barrier exchanges and an
// fp64 reciprocal); at small K that chain, not the lanes' coding, sets the
// pace, at K = 2048 also the lanes' loads, table reads, atomics and event
// stores through the SM's memory pipe.
#include "rc_encode.cuh"

// x [stride, K] u8 interleaved; lane_len [K] i32; ev [2*stride+2, K] u32.
// 1 to 32 lanes a thread (K <= 32768; from 16 lanes a thread the lane
// state spills to local memory). Returns the cudaError_t as an int
// (cudaErrorInvalidValue when K is too large).
extern "C" int ct_rcq_encode(const void* x, const void* lane_len, void* ev, int K, int stride,
                             int inc, uint32_t climit, void* stream) {
  EncodeFn fn = nullptr;
  switch (ct::lanes_per_thread(K)) {
    case 1: fn = launch_encode<1, 1, true, 1, false>; break;
    case 2: fn = launch_encode<2, 1, true, 1, false>; break;
    case 4: fn = launch_encode<4, 1, true, 1, false>; break;
    case 8: fn = launch_encode<8, 1, true, 1, false>; break;
    case 16: fn = launch_encode<16, 1, true, 1, false>; break;
    case 32: fn = launch_encode<32, 1, true, 1, false>; break;
  }
  if (!fn) return (int)cudaErrorInvalidValue;
  return (int)fn(x, lane_len, ev, nullptr, 1, K, stride, inc, climit, 0, 0,
                 (cudaStream_t)stream);
}

// Kernel O. x [steps, K] u8, the chunk's interleaved rows (steps may be 0);
// lane_len [K] i32, each lane's steps in the whole stream (lane i codes row
// j iff t0 + j < lane_len[i]); ev [2*steps + 2*flush, K] u32; st_in /
// st_out [5, K] u32 (low, carry, range, cache, cache_size); c_in / c_out
// [256] u32. The state out is the state after the steps; the flush rows
// follow where flush is set. Cache sizes must stay below 2^22 over the
// whole stream (the caller checks 3 * stride + 2 < 2^22). Returns the
// cudaError_t as an int (cudaErrorInvalidValue when K is too large).
extern "C" int ct_rcq_encode_chunk(const void* x, const void* lane_len, void* ev,
                                   const void* st_in, void* st_out, const void* c_in,
                                   void* c_out, int K, int steps, int t0, int flush, int inc,
                                   uint32_t climit, void* stream) {
  ResumeFn fn = nullptr;
  switch (ct::lanes_per_thread(K)) {
    case 1: fn = launch_encode_resume<1, 1, true, 1, false, true>; break;
    case 2: fn = launch_encode_resume<2, 1, true, 1, false, true>; break;
    case 4: fn = launch_encode_resume<4, 1, true, 1, false, true>; break;
    case 8: fn = launch_encode_resume<8, 1, true, 1, false, true>; break;
    case 16: fn = launch_encode_resume<16, 1, true, 1, false, true>; break;
    case 32: fn = launch_encode_resume<32, 1, true, 1, false, true>; break;
  }
  if (!fn) return (int)cudaErrorInvalidValue;
  const Resume rs{(const uint32_t*)st_in, (uint32_t*)st_out, (const uint32_t*)c_in,
                  (uint32_t*)c_out, t0, flush ? 1 : 0};
  return (int)fn(x, lane_len, ev, nullptr, 1, K, steps, inc, climit, 0, 0, rs,
                 (cudaStream_t)stream);
}
