// Shared pieces of the CT-RCX and CT-RCQ range-coder kernels: constants
// and the per-window requantization of the count model (the JAX package's
// models/cxmodel.py and models/qmodel.py are the specification;
// reference/rcx_ref.py and reference/rcq_ref.py the oracles). CT-RCQ is
// the one-row case (cbits = 0) requantized every step with one halving,
// by 8 warps in both of its kernels (requant_cells).
//
// Model layout, per stream, in shared memory (or in a global scratch
// buffer when it does not fit, cbits = 8):
//   C   u32 [rows, 256]         adaptive counts, +inc per coded symbol
//   cum u16 [rows, CUM_STRIDE]  the exclusive cumsum of the quantized table
//                               q (sums reach QTOTAL = 2^15, so u16 is
//                               exact): cum[s] for s = 0..256, cum[256] =
//                               QTOTAL, so q[s] = cum[s+1] - cum[s]. Kernel
//                               E keeps its one row in the search's tree
//                               order instead (rc_decode.cuh).
// A cum row is CUM_STRIDE = 258 u16 = 129 words, so rows start on
// different banks. 6 bytes a cell: rows = 2^cbits <= 128 fits the
// SMEM_LIMIT bytes a block may use; cbits = 8 takes global scratch (the
// cluster blocks of kernels A and C hold a quarter of C each, so all 256
// rows fit there).
#pragma once

#include <cooperative_groups.h>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace ct {

namespace cg = cooperative_groups;

constexpr uint32_t QBITS = 15;
constexpr uint32_t QTOTAL = 1u << QBITS;
constexpr uint32_t QRESERVE = 256;
constexpr uint32_t RC_TOP = 1u << 24;
constexpr uint32_t EV_RUN_MASK = (1u << 22) - 1;
constexpr int RESCALE_ROUNDS = 3;  // CT-RCX; CT-RCQ halves once
constexpr int MAX_THREADS = 1024;
// CT-RCX (kernels A and C) runs a stream of at least CLUSTER_MIN_K lanes as
// a cluster of CLUSTER_CTAS blocks
constexpr int CLUSTER_CTAS = 4, CLUSTER_MIN_K = 1024;
constexpr int CUM_STRIDE = 258;
constexpr uint32_t FULL = 0xFFFFFFFFu;
constexpr size_t SMEM_LIMIT = 232448;  // dynamic shared memory a Hopper block may use

__host__ __device__ inline size_t model_bytes(int rows) {
  size_t c = (size_t)rows * 256 * 4;
  size_t cum = ((size_t)rows * CUM_STRIDE * 2 + 15) & ~(size_t)15;
  return c + cum;
}

// Bytes of global scratch a one-block stream's model needs: 0 when it fits
// shared memory.
__host__ inline size_t scratch_bytes(int rows) {
  return model_bytes(rows) > SMEM_LIMIT ? model_bytes(rows) : 0;
}

// One thread per lane up to 1024 lanes, a multiple of 32 (whole warps).
__host__ inline int block_threads(int k) {
  int t = k < MAX_THREADS ? k : MAX_THREADS;
  return (t + 31) & ~31;
}

// Lanes each thread of a block of k lanes owns, rounded up to a power of
// two (each launcher instantiates the counts it takes). Lane state is a
// register array of this length, so a small count keeps a 1024-thread
// block within its 64 registers a thread.
__host__ inline int lanes_per_thread(int k) {
  const int need = (k + MAX_THREADS - 1) / MAX_THREADS;
  int lpt = 1;
  while (lpt < need) lpt *= 2;
  return lpt;
}

// C = 1 everywhere; the first window's requant fills cum.
__device__ inline void model_init(uint32_t* C, int rows) {
  for (int i = threadIdx.x; i < rows * 256; i += blockDim.x) C[i] = 1;
}

// floor(c * (QTOTAL - QRESERVE) / tot) for c <= tot < 2^32, given
// scale = RN(32512 * RN(1 / tot)), without a 64-bit divide (Hopper has
// none: nvcc calls a software routine). Exact: with u = 2^-53, y =
// RN(c * scale) carries three roundings, so |y - x| < 3.1 u x < 2^-36 for
// the true x = c * 32512 / tot <= 32512. x is a multiple of 1 / tot >
// 2^-32, so a non-integer x lies more than 2^-36 below the next integer
// and trunc(y) = floor(x); an integer x gives trunc(y) in {x - 1, x}. The
// candidate is thus floor(x) or one less, and one exact 64-bit product,
// (v + 1) * tot < 2^47, against c * 32512 < 2^47 settles it.
__device__ __forceinline__ uint32_t quant_div(uint32_t c, uint32_t tot, double scale) {
  uint32_t v = __double2uint_rz(__dmul_rn(__uint2double_rn(c), scale));
  if ((uint64_t)(v + 1) * tot <= (uint64_t)c * (QTOTAL - QRESERVE)) ++v;
  return v;
}

// Requantization of one context row by one warp, each lane owning the 8
// consecutive symbols 8*lane.. (two 16-byte loads of C):
//   up to ROUNDS halvings (c >> 1) | 1 while the row total is >= climit,
//   q = max(c * (QTOTAL - QRESERVE) / tot, 1) (quant_div, exact),
//   the remainder QTOTAL - sum(q) to the lowest-index maximum of q,
//   cum = exclusive warp scan of q.
// A row whose total is `same` is left as it is (kernel C skips a row that
// has not changed; 0, which no total is, skips nothing).
// -> the row total after the halvings, or 0 for a row left as it is
// (warp-uniform).
template <int ROUNDS>
__device__ inline uint32_t requant_row(uint32_t* crow, uint16_t* cr, uint32_t climit,
                                       uint32_t same = 0) {
  const int lane = threadIdx.x & 31;
  uint4* cv = reinterpret_cast<uint4*>(crow) + lane * 2;
  const uint4 a = cv[0], b = cv[1];
  uint32_t c[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += c[i];
  uint32_t tot = __reduce_add_sync(FULL, s);
  if (tot == same) return 0;
  if (tot >= climit) {
    for (int round = 0; round < ROUNDS && tot >= climit; ++round) {
      s = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        c[i] = (c[i] >> 1) | 1u;
        s += c[i];
      }
      tot = __reduce_add_sync(FULL, s);
    }
    cv[0] = make_uint4(c[0], c[1], c[2], c[3]);
    cv[1] = make_uint4(c[4], c[5], c[6], c[7]);
  }

  const double scale =
      __dmul_rn((double)(QTOTAL - QRESERVE), __drcp_rn(__uint2double_rn(tot)));
  uint32_t q[8];
  uint32_t qsum = 0, key = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t v = quant_div(c[i], tot, scale);
    q[i] = v > 1u ? v : 1u;
    qsum += q[i];
    // q < 2^16 above the complement of the index: the warp's largest key
    // is the largest q at its lowest index
    const uint32_t k = (q[i] << 8) | (255u - (uint32_t)(lane * 8 + i));
    key = k > key ? k : key;
  }
  const uint32_t rem = QTOTAL - __reduce_add_sync(FULL, qsum);
  const int besti = 255 - (int)(__reduce_max_sync(FULL, key) & 255u);
  if ((besti >> 3) == lane) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i == (besti & 7)) q[i] += rem;
  }

  uint32_t ex[8];
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    ex[i] = acc;
    acc += q[i];
  }
  uint32_t incl = acc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t v = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += v;
  }
  const uint32_t base = incl - acc;
  uint32_t* cw = reinterpret_cast<uint32_t*>(cr) + lane * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) cw[i] = (base + ex[2 * i]) | ((base + ex[2 * i + 1]) << 16);
  if (lane == 31) cr[256] = (uint16_t)QTOTAL;
  return tot;
}

// The window's requant of a one-block stream (kernels A and C), between two
// __syncthreads(): rows r = warp, warp + warps, ..., each one requantized
// unless its total is last[r]; last[r] then takes the new total, or 0 if
// it is >= climit. A row whose total is the one its last requant left below
// climit has not changed (counts only grow), and a requant would give it
// the same counts and cum row. (A requantized row may end on the total it
// had before: only requant_row can tell that it skipped a row.) TOUCHED
// (kernel A): the coding lanes set touched[r] beside each update of row r,
// and a row whose flag is clear and whose last[r] is not 0 is passed over
// without reading its counts; the flags read are cleared.
template <int ROUNDS, bool TOUCHED = false>
__device__ inline void requant_changed(uint32_t* C, uint16_t* cum, uint32_t* last, int rows,
                                       uint32_t climit, uint8_t* touched = nullptr) {
  const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < rows; r += nwarps) {
    if constexpr (TOUCHED) {
      if (!touched[r] && last[r] != 0) continue;
    }
    const uint32_t tot = requant_row<ROUNDS>(C + (size_t)r * 256, cum + (size_t)r * CUM_STRIDE,
                                             climit, TOUCHED ? 0u : last[r]);
    if (lane == 0 && tot != 0) last[r] = tot < climit ? tot : 0u;
    if constexpr (TOUCHED) {
      if (lane == 0) touched[r] = 0;
    }
  }
}

// The window's requant of a G-block cluster (kernels A and C), between two
// cluster barriers. Block g owns the rows r = g, g + G, ..., holding row
// r's counts in its C row r / G: warp i of the block takes the i-th of them
// in turn and, when it changed (requant_changed's rule), requantizes it and
// copies its cum row into every other block's copy of cum.
template <int ROUNDS, int G>
__device__ inline void requant_owned(uint32_t* C, uint16_t* cum, uint32_t* last, int rows,
                                     uint32_t climit, int g) {
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int r = g + G * (threadIdx.x >> 5); r < rows; r += G * nwarps) {
    uint16_t* cr = cum + (size_t)r * CUM_STRIDE;
    const uint32_t tot = requant_row<ROUNDS>(C + (size_t)(r / G) * 256, cr, climit, last[r]);
    if (tot == 0) continue;  // left as it is: every copy holds this cum row
    if (lane == 0) last[r] = tot < climit ? tot : 0u;
    __syncwarp();  // the row's cum, stored by every lane, before the copy
    uint32_t* src = reinterpret_cast<uint32_t*>(cr);
#pragma unroll
    for (int o = 1; o < G; ++o) {
      uint32_t* dst = cluster.map_shared_rank(src, (unsigned)((g + o) % G));
      for (int k = lane; k < CUM_STRIDE / 2; k += 32) dst[k] = src[k];
    }
  }
}

// The one-row requant of CT-RCQ (kernels D and E), run by threads 0..255,
// one cell a thread.
constexpr int CELL_THREADS = 256;

// Threads of a one-stream block: one a lane (block_threads), and at least
// a warp a model row, or one a cell for requant_cells, up to 1024.
__host__ inline int coder_threads(int k, int rows, bool cells) {
  const int need = cells ? CELL_THREADS : 32 * rows;
  const int t = block_threads(k), r = need < MAX_THREADS ? need : MAX_THREADS;
  return t > r ? t : r;
}

// A tree-ordered cum row (kernel E) holds at node k = 1..255 (breadth-
// first, from 1) the exclusive cum of the symbol that the binary search
// over 0..255 tests there, so that node 2k or 2k + 1 follows node k.
// Symbol s = (2p + 1) << (7 - d) (1..255) is node p of level d: node
// 2^d + p.
__device__ __forceinline__ int tree_node(int s) {
  const int tz = __ffs(s) - 1;
  return (1 << (7 - tz)) | (s >> (tz + 1));
}

// Warps 0..7 meet at named barrier 1; the other warps go on.
__device__ __forceinline__ void cells_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(CELL_THREADS) : "memory");
}

// v summed over threads 0..255, through x[0..7].
__device__ __forceinline__ uint32_t cells_sum(uint32_t* x, uint32_t v) {
  const uint32_t w = __reduce_add_sync(FULL, v);
  if ((threadIdx.x & 31) == 0) x[threadIdx.x >> 5] = w;
  cells_barrier();
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += x[i];
  return s;
}

// requant_row's function for the single row C[256], run by threads 0..255,
// thread t owning cell t, through three exchanges at named barrier 1 (the
// total, the sum and first argmax of q, the scan); x gives each exchange
// its own 8 words, so no exchange waits for the reads of the one before.
// The cum row is stored in the search's tree order (TREE, kernel E: nodes
// 1..255) or sorted (kernel D: cr[0..256], which the coder reads at s and
// s + 1).
template <int ROUNDS, bool TREE>
__device__ inline void requant_cells(uint32_t* C, uint16_t* cr, uint32_t climit,
                                     uint32_t (*x)[8]) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  uint32_t c = C[t];
  uint32_t tot = cells_sum(x[0], c);
  if (tot >= climit) {
    for (int round = 0; round < ROUNDS && tot >= climit; ++round) {
      c = (c >> 1) | 1u;
      tot = cells_sum(x[1 + round], c);
    }
    C[t] = c;
  }
  const double scale =
      __dmul_rn((double)(QTOTAL - QRESERVE), __drcp_rn(__uint2double_rn(tot)));
  uint32_t q = quant_div(c, tot, scale);
  q = q > 1u ? q : 1u;
  // q < 2^16 above the complement of the cell: the largest key is the
  // largest q at its lowest cell
  const uint32_t qs = __reduce_add_sync(FULL, q);
  const uint32_t km = __reduce_max_sync(FULL, (q << 8) | (255u - (uint32_t)t));
  uint32_t* xs = x[ROUNDS + 1];
  uint32_t* xk = x[ROUNDS + 2];
  if (lane == 0) {
    xs[warp] = qs;
    xk[warp] = km;
  }
  cells_barrier();
  uint32_t qsum = 0, kmax = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    qsum += xs[i];
    kmax = xk[i] > kmax ? xk[i] : kmax;
  }
  if (t == 255 - (int)(kmax & 255u)) q += QTOTAL - qsum;
  uint32_t incl = q;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t v = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += v;
  }
  uint32_t* xw = x[ROUNDS + 3];
  if (lane == 31) xw[warp] = incl;
  cells_barrier();
  uint32_t base = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) base += i < warp ? xw[i] : 0u;
  if constexpr (TREE) {
    if (t > 0) cr[tree_node(t)] = (uint16_t)(base + incl - q);
  } else {
    cr[t] = (uint16_t)(base + incl - q);
    if (t == 255) cr[256] = (uint16_t)QTOTAL;
  }
}

// Opts `kernel` in to `bytes` of dynamic shared memory where that is above
// the 48 KB a launch may take without; returns the refusal, if any.
template <typename Kernel>
inline cudaError_t prepare_smem(Kernel kernel, size_t bytes) {
  if (bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  return cudaSuccess;
}

// Launches `kernel` as streams * G blocks of `threads`, a cluster of G
// blocks a stream when G > 1, with `smem` bytes of dynamic shared memory;
// returns the first refusal, else cudaGetLastError().
template <int G, typename... Params, typename... Args>
inline cudaError_t launch_streams(void (*kernel)(Params...), int streams, int threads,
                                  size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = prepare_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(streams * G);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = G;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = G > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace ct
