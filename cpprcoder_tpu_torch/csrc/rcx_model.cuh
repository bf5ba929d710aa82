// CT-RCX shared pieces of the encode and decode kernels: constants, the
// range-coder shift_low, and the per-window requantization of the order-1
// context model (models/cxmodel.py of the JAX package is the
// specification; reference/rcx_ref.py the oracle).
//
// Model layout, per stream, in shared memory (or in a global scratch
// buffer when it does not fit, cbits = 8):
//   C   u32 [rows, 256]  adaptive counts, +inc per coded symbol (atomics)
//   cum u16 [rows, 257]  inclusive cumsum of the quantized table q, with a
//                        leading 0: q[s] = cum[s+1] - cum[s], and the
//                        exclusive cum of s is cum[s]. Sums reach
//                        QTOTAL = 2^15, so u16 is exact.
// 6 bytes a cell: rows = 2^cbits <= 128 fits the 227 KB a block may use.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace ct {

constexpr uint32_t QBITS = 15;
constexpr uint32_t QTOTAL = 1u << QBITS;
constexpr uint32_t QRESERVE = 256;
constexpr uint32_t RC_TOP = 1u << 24;
constexpr uint32_t EV_RUN_MASK = (1u << 22) - 1;
constexpr int RESCALE_ROUNDS = 3;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_LPT = 8;  // lanes per thread: K <= MAX_LPT * MAX_THREADS

__host__ __device__ inline size_t model_bytes(int rows) {
  size_t c = (size_t)rows * 256 * 4;
  size_t cum = ((size_t)rows * 257 * 2 + 15) & ~(size_t)15;
  return c + cum;
}

// One thread per lane up to 1024 lanes, a multiple of 32 (whole warps).
__host__ inline int block_threads(int k) {
  int t = k < MAX_THREADS ? k : MAX_THREADS;
  return (t + 31) & ~31;
}

// Lanes each thread owns, rounded up to the kernel instantiations 1/2/4/8
// (0: K too large). Lane state is a register array of this length, so a
// small count keeps a 1024-thread block within its 64 registers a thread.
__host__ inline int lanes_per_thread(int k) {
  const int need = (k + MAX_THREADS - 1) / MAX_THREADS;
  for (int lpt = 1; lpt <= MAX_LPT; lpt *= 2)
    if (need <= lpt) return lpt;
  return 0;
}

__device__ inline uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// C = 1 everywhere; the first window's requant fills cum.
__device__ inline void model_init(uint32_t* C, int rows) {
  for (int i = threadIdx.x; i < rows * 256; i += blockDim.x) C[i] = 1;
}

// Window requantization of every context row, one warp per row, each lane
// owning 8 consecutive symbols:
//   up to 3 halvings (c >> 1) | 1 while the row total is >= climit,
//   q = max(c * (QTOTAL - QRESERVE) / tot, 1) (64-bit product, exact),
//   the remainder QTOTAL - sum(q) to the lowest-index maximum of q,
//   cum = inclusive warp scan of q.
// Callers put a __syncthreads() on both sides.
__device__ inline void requant(uint32_t* C, uint16_t* cum, int rows, uint32_t climit) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < rows; r += nwarps) {
    uint32_t* crow = C + (size_t)r * 256 + lane * 8;
    uint32_t c[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) c[i] = crow[i];
    uint32_t tot = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) tot += c[i];
    tot = warp_sum(tot);
    for (int round = 0; round < RESCALE_ROUNDS && tot >= climit; ++round) {
      uint32_t s = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        c[i] = (c[i] >> 1) | 1u;
        s += c[i];
      }
      tot = warp_sum(s);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) crow[i] = c[i];

    uint32_t q[8];
    uint32_t qsum = 0, best = 0;
    int besti = 256;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint32_t v = (uint32_t)(((uint64_t)c[i] * (QTOTAL - QRESERVE)) / tot);
      q[i] = v > 1u ? v : 1u;
      qsum += q[i];
      if (q[i] > best) {  // strict: keeps the first maximum of this lane
        best = q[i];
        besti = lane * 8 + i;
      }
    }
    const uint32_t rem = QTOTAL - warp_sum(qsum);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      uint32_t ob = __shfl_xor_sync(0xffffffffu, best, off);
      int oi = __shfl_xor_sync(0xffffffffu, besti, off);
      if (ob > best || (ob == best && oi < besti)) {
        best = ob;
        besti = oi;
      }
    }
    if ((besti >> 3) == lane) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i == (besti & 7)) q[i] += rem;
    }

    uint32_t run[8];
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc += q[i];
      run[i] = acc;
    }
    uint32_t incl = acc;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      uint32_t v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    const uint32_t base = incl - acc;
    uint16_t* cr = cum + (size_t)r * 257;
    if (lane == 0) cr[0] = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) cr[lane * 8 + i + 1] = (uint16_t)(base + run[i]);
  }
}

// The model of stream `s`: global scratch when given, else dynamic shared.
__device__ inline void model_ptrs(uint8_t* smem, uint8_t* gmodel, int rows,
                                  uint32_t** C, uint16_t** cum) {
  uint8_t* base = gmodel ? gmodel + (size_t)blockIdx.x * model_bytes(rows) : smem;
  *C = reinterpret_cast<uint32_t*>(base);
  *cum = reinterpret_cast<uint16_t*>(base + (size_t)rows * 256 * 4);
}

// Shared memory the launch asks for: none when the model is in global
// scratch. Above 48 KB a kernel needs the opt-in attribute.
template <typename Kernel>
inline size_t prepare_smem(Kernel kernel, const void* gmodel, int rows) {
  if (gmodel) return 0;
  size_t smem = model_bytes(rows);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return smem;
}

}  // namespace ct
