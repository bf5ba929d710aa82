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
// consecutive bytes a step across the block), for one model row requantized
// before every step, one CTA a stream: 8 warps requantize the row, one cell
// a thread (fp64 reciprocal division, warp reductions and a scan exchanged
// through shared memory), and store its cum in tree order; the lanes walk
// that tree (8 reads in shared memory, where the Pallas kernel made a
// two-level 16x16 one-hot search) and load their next word a refill ahead.
//
// ct_rcq_decode_steps is its stepped lane-range form (rc_decode.cuh), one
// step a launch, for one rank's lanes of a stream sharded over the 'lane'
// axis (parallel/sharded_rcq.py; the JAX package psums the decoded
// symbols' histogram at every step, sharded_rcq.py:185).
//
// What bounds it: the sequential steps on one SM, and at every step the
// requant between two __syncthreads; at K = 2048 also the lanes' search
// reads and atomics through the SM's shared-memory pipe.
#include "rc_decode.cuh"

// words [l4, K] u32 big-endian word rows; lane_len [K] i32; out [K*stride]
// u8. 1 to 32 lanes a thread (K <= 32768; from 16 lanes a thread the lane
// state spills to local memory). Returns the cudaError_t as an int
// (cudaErrorInvalidValue when K is too large).
extern "C" int ct_rcq_decode(const void* words, const void* lane_len, void* out, int K, int l4,
                             int stride, int inc, uint32_t climit, void* stream) {
  LaunchFn fn = nullptr;
  switch (ct::lanes_per_thread(K)) {
    case 1: fn = launch_kernel<1, 1, true, false, 1>; break;
    case 2: fn = launch_kernel<2, 1, true, false, 1>; break;
    case 4: fn = launch_kernel<4, 1, true, false, 1>; break;
    case 8: fn = launch_kernel<8, 1, true, false, 1>; break;
    case 16: fn = launch_kernel<16, 1, true, false, 1>; break;
    case 32: fn = launch_kernel<32, 1, true, false, 1>; break;
  }
  if (!fn) return (int)cudaErrorInvalidValue;
  return (int)fn(words, lane_len, out, nullptr, 1, K, l4, stride, inc, climit, 0, 0,
                 (cudaStream_t)stream);
}

// The stepped lane-range form, one step a launch: ct_rcx_decode_steps's
// arguments with one row (C [streams, 1, 256]), one halving, wlog = 0.
extern "C" int ct_rcq_decode_steps(const void* words, const void* lane_len, void* st, void* C,
                                   void* prev, const void* xs, void* out, int streams, int K,
                                   int l4, int l0, int ko, int t0, int steps, int np, int inc,
                                   uint32_t climit, void* stream) {
  return (int)launch_decode_steps<1>(words, lane_len, st, C, prev, xs, out, streams, K, l4, l0,
                                     ko, t0, steps, np, inc, climit, 0, 0, (cudaStream_t)stream);
}
