// Kernels P and Q: the CT-LZ4 (SLZ4) v2 encode's parse walk (P) and token
// serializer (Q), on Hopper.
//
// They replace no Pallas kernel: the JAX package runs these steps as XLA
// code shaped by Mosaic's limits (cpprcoder_tpu/ops/lz_ops.py):
//   - P: `_greedy_membership` (:644-692), per-128-position jump tables built
//     by one-hot MXU dots, one lax.scan across the blocks and an orbit
//     doubling inside them, then the sort that lists the matches (:730-742);
//   - Q: the byte-exact clamp (:716-728, cummax/cummin propagation) and
//     `_serialize_fn_v2` (:396-500, a scatter and a packed cummax that give
//     every output byte its token; the packing wraps past 2^18 tokens, C1).
// The spec is reference/slz4_ref.py (`parse_segment_v2`, `serialize_tokens`).
//
// P. Segment i's walk goes from position 0 to p + step[p] (step >= 1; a
// position with step > 1 is a match, of length step) until it passes W.
// The chain is serial, so it is cut into blocks of B positions (128 up to
// W = 2^17, else W / 1024 rounded up: at most 1024 blocks), one thread a
// block, one CTA a segment:
//   1. each thread scans its block backwards: exit[p] = the first position
//      at or past the block's end that the walk from p reaches (p + step[p]
//      if that leaves the block, else exit[p + step[p]]; a literal reuses
//      the exit of p + 1 from a register);
//   2. thread 0 hops from 0 along the exits, one per block at most, and
//      records where the walk enters each block;
//   3. each thread walks its block from its entry and counts its matches; a
//      scan of the counts gives each block its first output slot, and a
//      second walk writes (position, length, offset) there.
// Bound: bytes (step and off read, the matches written). What holds it
// back: the dependent loads of the scan and of thread 0's hops (at most
// 1024 a segment), and one CTA a segment.
//
// Q. Three launches over the tokens (a match, and one last token of
// literals a segment), with a cumsum of their sizes between the last two:
//   1. clamp: a warp a match compares it with its source 32 bytes at a time
//      (a ballot finds the first mismatch): its clamped length;
//   2. sizes: a thread a token. Token t's literals run from match t - 1's
//      clamped end to match t (the last token's to the segment's length):
//      the header byte, the 255-runs of both lengths, the literals, the u16
//      offset;
//   3. write: after an exclusive cumsum (in int64, across all segments) a
//      warp a token writes its bytes, each lane every 32nd.
// Bound: bytes (the input read once, the payload written once).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WALK_BLOCK = 128;    // positions a block up to W = 2^17
constexpr int MAX_BLOCKS = 1024;   // blocks a segment: a thread each
constexpr int MIN_MATCH = 4;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(MAX_BLOCKS)
walk_kernel(const int32_t* __restrict__ step, const int32_t* __restrict__ off,
            int32_t* exits, int32_t* __restrict__ mpos, int32_t* __restrict__ mlen,
            int32_t* __restrict__ moff, int32_t* __restrict__ count, int w, int blen,
            int nb, int tcap) {
  __shared__ int entry[MAX_BLOCKS];
  __shared__ int warp_sum[32];
  const long long row = (long long)blockIdx.x * w;
  const int32_t* st = step + row;
  int32_t* ex = exits + row;
  const int b = threadIdx.x;
  const int lo = b * blen;
  const int hi = b < nb ? min(lo + blen, w) : 0;
  if (b < nb) {
    entry[b] = -1;
    int last = 0;   // exit[p + 1]
    for (int p = hi - 1; p >= lo; --p) {
      const int nx = p + st[p];
      const int e = nx >= hi ? nx : (nx == p + 1 ? last : ex[nx]);
      ex[p] = e;
      last = e;
    }
  }
  __syncthreads();
  if (b == 0) {
    for (int p = 0; p < w; p = ex[p]) entry[p / blen] = p;
  }
  __syncthreads();
  const int e0 = b < nb ? entry[b] : -1;
  int c = 0;
  if (e0 >= 0) {
    for (int p = e0; p < hi;) {
      const int s = st[p];
      c += s > 1;
      p += s;
    }
  }
  // exclusive scan of the counts over the CTA
  const int lane = b & 31, wid = b >> 5, nw = blockDim.x >> 5;
  int v = c;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += t;
  }
  if (lane == 31) warp_sum[wid] = v;
  __syncthreads();
  if (wid == 0) {
    int t = lane < nw ? warp_sum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, t, o);
      if (lane >= o) t += u;
    }
    warp_sum[lane] = t;
  }
  __syncthreads();
  int k = v - c + (wid > 0 ? warp_sum[wid - 1] : 0);
  if (e0 >= 0) {
    const long long orow = (long long)blockIdx.x * tcap;
    for (int p = e0; p < hi;) {
      const int s = st[p];
      if (s > 1) {
        mpos[orow + k] = p;
        mlen[orow + k] = s;
        moff[orow + k] = off[row + p];
        ++k;
      }
      p += s;
    }
  }
  if (b == 0) count[blockIdx.x] = warp_sum[nw - 1];
}

__device__ __forceinline__ int ext_len(int v) { return v >= 15 ? (v - 15) / 255 + 1 : 0; }

struct Token {
  int ls, ll, m, off;   // literal start, literal length, match length, offset
};

// Token t of a segment with c matches (t == c: the last, literals only);
// moff null: the offset is not read.
__device__ __forceinline__ Token token_at(const int32_t* mpos, const int32_t* clamped,
                                          const int32_t* moff, long long rowk, int t, int c,
                                          int len) {
  Token tk;
  tk.ls = t == 0 ? 0 : mpos[rowk + t - 1] + clamped[rowk + t - 1];
  const bool last = t == c;
  tk.ll = (last ? len : mpos[rowk + t]) - tk.ls;
  tk.m = last ? 0 : clamped[rowk + t];
  tk.off = last || moff == nullptr ? 0 : moff[rowk + t];
  return tk;
}

__device__ __forceinline__ int token_size(const Token& tk) {
  return 1 + ext_len(tk.ll) + tk.ll + (tk.m > 0 ? 2 + ext_len(tk.m - MIN_MATCH) : 0);
}

__global__ void clamp_kernel(const uint8_t* __restrict__ rows, const int32_t* __restrict__ mpos,
                             const int32_t* __restrict__ mlen, const int32_t* __restrict__ moff,
                             const int32_t* __restrict__ count, int32_t* __restrict__ clamped,
                             int n, int w, int tcap, int tmax) {
  const long long g = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (g >= (long long)n * tmax) return;
  const int seg = (int)(g / tmax), t = (int)(g % tmax);
  if (t >= count[seg]) return;
  const long long k = (long long)seg * tcap + t;
  const int p = mpos[k], m = mlen[k], o = moff[k];
  const uint8_t* x = rows + (long long)seg * w;
  int j = m;
  for (int j0 = 0; j0 < m; j0 += 32) {
    const int jj = j0 + lane;
    const unsigned ne = __ballot_sync(FULL, jj < m && x[p + jj] != x[p - o + jj]);
    if (ne) {
      j = j0 + __ffs(ne) - 1;
      break;
    }
  }
  if (lane == 0) clamped[k] = j;
}

__global__ void sizes_kernel(const int32_t* __restrict__ mpos, const int32_t* __restrict__ clamped,
                             const int32_t* __restrict__ count, const long long* __restrict__ lens,
                             long long* __restrict__ size, int n, int tcap, int tmax) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)n * tmax) return;
  const int seg = (int)(g / tmax), t = (int)(g % tmax);
  const int c = count[seg];
  if (t > c) {
    size[g] = 0;
    return;
  }
  const Token tk = token_at(mpos, clamped, nullptr, (long long)seg * tcap, t, c, (int)lens[seg]);
  size[g] = token_size(tk);
}

__global__ void write_kernel(const uint8_t* __restrict__ rows, const int32_t* __restrict__ mpos,
                             const int32_t* __restrict__ clamped, const int32_t* __restrict__ moff,
                             const int32_t* __restrict__ count, const long long* __restrict__ lens,
                             const long long* __restrict__ ends, const long long* __restrict__ size,
                             uint8_t* __restrict__ payload, int n, int w, int tcap, int tmax) {
  const long long g = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (g >= (long long)n * tmax) return;
  const int seg = (int)(g / tmax), t = (int)(g % tmax);
  const int c = count[seg];
  if (t > c) return;
  const Token tk = token_at(mpos, clamped, moff, (long long)seg * tcap, t, c, (int)lens[seg]);
  const int sz = (int)size[g];
  uint8_t* dst = payload + (ends[g] - sz);
  const uint8_t* x = rows + (long long)seg * w + tk.ls;
  const int el = ext_len(tk.ll), mx = tk.m - MIN_MATCH;
  const int lrem = tk.ll - 15, mrem = mx - 15;
  for (int u = lane; u < sz; u += 32) {
    int v;
    if (u == 0) {
      v = (min(tk.ll, 15) << 4) | (tk.m > 0 ? min(mx, 15) : 0);
    } else if (u < 1 + el) {
      v = u - 1 < lrem / 255 ? 255 : lrem % 255;
    } else if (u < 1 + el + tk.ll) {
      v = x[u - 1 - el];
    } else {
      const int o = u - 1 - el - tk.ll;
      if (o == 0) v = tk.off & 255;
      else if (o == 1) v = tk.off >> 8;
      else v = o - 2 < mrem / 255 ? 255 : mrem % 255;
    }
    dst[u] = (uint8_t)v;
  }
}

int warp_blocks(long long warps, int threads) {
  return (int)((warps * 32 + threads - 1) / threads);
}

}  // namespace

// step, off int32 [n, w] -> mpos, mlen, moff int32 [n, tcap] (zeroed by the
// caller; the walk's matches in order), count int32 [n]; exits int32 [n, w]
// is scratch.
extern "C" int ct_lz_walk(const void* step, const void* off, void* exits, void* mpos, void* mlen,
                          void* moff, void* count, int n, int w, int tcap, void* stream) {
  const int blen = w <= WALK_BLOCK * MAX_BLOCKS ? min(WALK_BLOCK, w)
                                                 : (w + MAX_BLOCKS - 1) / MAX_BLOCKS;
  const int nb = (w + blen - 1) / blen;
  const int threads = (nb + 31) / 32 * 32;
  walk_kernel<<<n, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)step, (const int32_t*)off, (int32_t*)exits, (int32_t*)mpos,
      (int32_t*)mlen, (int32_t*)moff, (int32_t*)count, w, blen, nb, tcap);
  return (int)cudaGetLastError();
}

// rows uint8 [n, w] and P's matches -> clamped int32 [n, tcap]; tmax - 1 is
// the largest count.
extern "C" int ct_lz_clamp(const void* rows, const void* mpos, const void* mlen, const void* moff,
                           const void* count, void* clamped, int n, int w, int tcap, int tmax,
                           void* stream) {
  const int threads = 256;
  clamp_kernel<<<warp_blocks((long long)n * tmax, threads), threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)rows, (const int32_t*)mpos, (const int32_t*)mlen, (const int32_t*)moff,
      (const int32_t*)count, (int32_t*)clamped, n, w, tcap, tmax);
  return (int)cudaGetLastError();
}

// -> size int64 [n, tmax]: token t's bytes (0 past the last token).
extern "C" int ct_lz_sizes(const void* mpos, const void* clamped, const void* count,
                           const void* lens, void* size, int n, int tcap, int tmax, void* stream) {
  const int threads = 256;
  const long long tokens = (long long)n * tmax;
  sizes_kernel<<<(int)((tokens + threads - 1) / threads), threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)mpos, (const int32_t*)clamped, (const int32_t*)count,
      (const long long*)lens, (long long*)size, n, tcap, tmax);
  return (int)cudaGetLastError();
}

// ends int64 [n * tmax]: the inclusive cumsum of size -> payload bytes.
extern "C" int ct_lz_write(const void* rows, const void* mpos, const void* clamped,
                           const void* moff, const void* count, const void* lens, const void* ends,
                           const void* size, void* payload, int n, int w, int tcap, int tmax,
                           void* stream) {
  const int threads = 256;
  write_kernel<<<warp_blocks((long long)n * tmax, threads), threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)rows, (const int32_t*)mpos, (const int32_t*)clamped, (const int32_t*)moff,
      (const int32_t*)count, (const long long*)lens, (const long long*)ends,
      (const long long*)size, (uint8_t*)payload, n, w, tcap, tmax);
  return (int)cudaGetLastError();
}
