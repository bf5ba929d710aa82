// The sort primitive of kernels K (lz_match_v2.cu) and Z (lz_match.cu):
// a CTA's block merge sort, and the merge path that merges two sorted runs
// in it and, across CTAs, in K's global passes.
//
// A thread holds ITEMS keys in registers (a blocked arrangement: thread t
// the keys t * ITEMS ..). It sorts them by an odd-even transposition
// network in registers, then the CTA merges runs of ITEMS, 2 * ITEMS, ...
// through shared memory: each round a thread finds where its ITEMS outputs
// start in its pair of runs by a merge path search, then merges ITEMS keys
// serially into its registers. A round is two barriers, so a CTA of 4,096
// keys takes 20 (a bitonic sort in shared memory: 78).
//
// Ties: a run's keys come before the other run's equal ones (a stable
// merge). K's keys are distinct (the position is their last field).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ct {

// Of the first `diag` keys of the stable merge of sorted a[0, a_len) and
// b[0, b_len), how many are a's. `a` and `b` are anything indexable.
template <class A, class B>
__device__ __forceinline__ int merge_path(const A& a, int a_len, const B& b, int b_len,
                                          int diag) {
  int lo = max(0, diag - b_len), hi = min(diag, a_len);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (b[diag - 1 - mid] < a[mid])
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// merge_path by a whole warp (every lane calls it with the same arguments
// and gets the answer): each round tests 32 points of the range, so a
// search over 2^k keys takes about k / 5 rounds of loads, not k.
template <class A, class B>
__device__ __forceinline__ int warp_merge_path(const A& a, int a_len, const B& b, int b_len,
                                               int diag) {
  const int lane = threadIdx.x & 31;
  int lo = max(0, diag - b_len), hi = min(diag, a_len);
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int m = lo + lane * step;
    const bool first = m < hi && !(b[diag - 1 - m] < a[m]);  // a[m] among the first diag
    const int c = __popc(__ballot_sync(0xFFFFFFFFu, first));
    if (c == 0) {
      hi = lo;
    } else {
      hi = min(hi, lo + c * step);
      lo += (c - 1) * step + 1;
    }
  }
  return lo;
}

// The next ITEMS keys of the stable merge of a[0, a_len) and b[0, b_len)
// from a[i], b[j] on, into out (past both runs' ends: stale keys).
template <int ITEMS, class T, class A, class B>
__device__ __forceinline__ void serial_merge(const A& a, int a_len, const B& b, int b_len,
                                             int i, int j, T (&out)[ITEMS]) {
  T x = i < a_len ? a[i] : T(), y = j < b_len ? b[j] : T();
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const bool take_b = j < b_len && (i >= a_len || y < x);
    out[k] = take_b ? y : x;
    if (take_b) {
      if (++j < b_len) y = b[j];
    } else {
      if (++i < a_len) x = a[i];
    }
  }
}

// The CTA sorts ITEMS * blockDim.x keys (blockDim.x a power of two), its
// thread t's it[0..ITEMS) in, the keys of ranks t * ITEMS .. out; sh holds
// ITEMS * blockDim.x keys. Called by every thread; it starts with a
// barrier, so sh may be in use until the call.
template <int ITEMS, class T>
__device__ void block_sort(T (&it)[ITEMS], T* sh) {
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
#pragma unroll
    for (int j = r & 1; j + 1 < ITEMS; j += 2) {
      if (it[j + 1] < it[j]) {
        const T t = it[j];
        it[j] = it[j + 1];
        it[j + 1] = t;
      }
    }
  }
  const int n = ITEMS * (int)blockDim.x, t0 = ITEMS * (int)threadIdx.x;
  for (int width = ITEMS; width < n; width <<= 1) {
    __syncthreads();
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) sh[t0 + k] = it[k];
    __syncthreads();
    const int gs = t0 & ~(2 * width - 1), d = t0 - gs;
    const T* a = sh + gs;
    const T* b = a + width;
    const int i = merge_path(a, width, b, width, d);
    serial_merge(a, width, b, width, i, d - i, it);
  }
}

}  // namespace ct
