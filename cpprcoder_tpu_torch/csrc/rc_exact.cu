// Kernels J and L: CT-RC1 (static) and CT-RC2 (adaptive) range coding on
// Hopper.
//
// They replace no Pallas kernel: the JAX package runs these coders as one
// compiled lax.scan each on the device (cpprcoder_tpu/ops/range_ops.py:51-91
// CT-RC1 encode, :94-132 CT-RC2 encode, :273-311 CT-RC1 decode, :314-366
// CT-RC2 decode). The reference's byte loop is cpprcoder.h:400-436, 697-742.
//
// What they compute, per stream of n bytes over K interleaved lanes (lane i
// codes x[j*K + i] at step j, j < lane_len[i]):
//   - CT-RC1: one static table freqs[256] of total 2^16, t = range >> 16;
//   - CT-RC2: one adaptive table for all lanes, starting at freqs = 1. Before
//     each step, if total >= limit then freqs = (freqs >> 1) | 1; every
//     lane codes its symbol with t = range / total; then each active lane
//     adds inc to its symbol's count;
//   - the coder: low += t*c; range = (c + f == total) ? range - t*c : t*f;
//     then up to SLOTS shift_lows while range < 2^24. SLOTS comes from
//     range_ops.slots: 2, or 3 where CT-RC2's total can pass 2^16 (the
//     total never exceeds max(2^limit - 1, K*inc + 512); the proof is in
//     that function's docstring). Encode (J) writes one packed event per
//     slot, time-major [SLOTS*stride + 2, K], then two flush rows
//     (ops/rc_common.py's format, the one kernel B reads). Decode (L) takes
//     each lane's big-endian word row; a 64-bit queue takes a whole word
//     when fewer than SLOTS bytes are buffered (bytes past the lane's end
//     read as zero); the symbol is the largest s with cum[s] <= min(code / t,
//     total - 1); lane i's step-j byte goes to out[j*K + i].
//
// Design. The first design (one CTA a stream, up to 8 lanes a thread) paid
// four costs on each step's chain: two barriers around warp 0's table scan
// (CT-RC2), a global load (J's symbol, L's next word), an integer divide
// range / total, and L's 8 dependent shared reads.
//   - Every coder step is branch-free (the shift_lows and the decoder's
//     byte queue as selects) and divides range by a table's total with a
//     multiply-high by its magic number and one correction (div_magic).
//   - J, CT-RC2: the model depends only on x, so each CTA (64 lanes up to
//     K = 1,024, else 256; each CTA rebuilds the same tables) has producer
//     warps that run
//     ahead of its lanes. H histogram warps bring tiles of x rows into
//     shared memory by cp.async and add each row's bytes to cumulative
//     histograms (8 copies, so that equal bytes of a warp spread over 8
//     addresses; none is ever cleared). One table warp, with no global
//     memory traffic, keeps the counts in registers, adds each row's
//     histogram (the growth of the cumulative one), halves, scans and
//     publishes cum[257], total and magic into a ring of RING slots, one
//     progress counter for all. The coder lanes wait only for their step's
//     slot (reading the counter again only when they catch up) and report
//     their progress after each group of steps, so that no slot in use is
//     overwritten: no barrier among the lanes. They load their symbols a
//     group ahead, two groups in turn (groups of 16 steps in CTAs of 64
//     lanes, 8 in CTAs of 256).
//   - J and L, CT-RC1: the lanes share a constant table and nothing else:
//     CTAs of 64 (J) or 128 (L) lanes, as many as K needs. L decodes the
//     symbol from a 2^16-entry u8 table in dynamic shared memory (64 KiB
//     behind the opt-in), filled per CTA, and keeps each lane's next two
//     words in registers (CT-RC2's lanes too, in CTAs of more than 256
//     threads); v = code / t stays a 32-bit divide (t differs per lane).
//   - L, CT-RC2: step j+1's table needs every lane's step-j symbol: one
//     barrier a step. Lanes add their symbols and the count of active lanes
//     to a cumulative histogram (two, by step parity); after the barrier
//     every warp derives the next table itself (counts in registers, the
//     same in every warp), halves, scans and writes its own cum row,
//     pivots (every 16th cum entry), total and magic number, so no warp
//     waits on another's scan. A lane finds its symbol with no divide: the
//     largest s with t*cum[s] <= code (the reference's search, since
//     t*cum <= t*total <= range fits 32 bits and every count is at least
//     1), by counting the pivots at or below, then 4 shared reads, in CTAs
//     of up to 128 threads; else (more warps, more table copies to write)
//     by 8 shared reads. Up to 4,096 lanes
//     a CTA (1 to 4 a thread); more lanes run a cluster of up to 8 CTAs (8
//     lanes a thread at 65,536) that read each other's histograms through
//     distributed shared memory, one cluster barrier a step.
//   - Tables are held split across a warp (lane l: symbols 4l..4l+3 and
//     128+4l..128+4l+3), so that a row's 16-byte loads and stores hit
//     distinct banks.
//
// What bounds it: a stream's steps are sequential. J's CT-RC2 step is paced
// by the table warp's chain (the histogram's shared reads, adds, a halving
// every few steps, a 5-level shuffle scan, the publication); its CT-RC1 step
// and L's CT-RC1 step by one lane's chain; L's CT-RC2 step by the search,
// the barrier and a warp's table build, one after the other.
#include <cooperative_groups.h>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t RC_TOP = 1u << 24;
constexpr uint32_t EV_RUN_MASK = (1u << 22) - 1;
constexpr uint32_t STATIC_TOTAL = 1u << 16;
constexpr uint32_t FULL = 0xFFFFFFFFu;

// kernel J
constexpr int ENC_STATIC_LANES = 64;     // coder threads a CTA, CT-RC1
constexpr int ENC_ADAPTIVE_LANES = 256;  // coder threads a CTA, CT-RC2, the most
constexpr int ENC_ADAPTIVE_SMALL = 64;   // ... and up to ENC_SMALL_K lanes
constexpr int ENC_SMALL_K = 1024;
constexpr int MAX_HIST_WARPS = 8;        // CT-RC2's histogram warps a CTA
constexpr int AHEAD = 8;                 // steps in a group of a lane's symbols
constexpr int AHEAD_SMALL = 16;          // ... in CTAs of ENC_ADAPTIVE_SMALL lanes
constexpr int RING = 16;                 // CT-RC2 tables in flight a CTA
constexpr int HIST_COPIES = 8;           // J's histograms, by histogram lane & 7
constexpr int STAGE_BYTES = 4096;        // a tile of x rows for the histograms
constexpr int SLOT_WORDS = 264;          // a ring slot: cum[257], total, magic
constexpr int SLOT_TOTAL = 257, SLOT_MAGIC = 258;
constexpr int HIST_WORDS = 260;          // 256 counts, then the active lanes
constexpr int HIST_ACTIVE = 256;

// kernel L
constexpr int DEC_STATIC_THREADS = 128;
constexpr int DEC_CTA_LANES = 4096;      // CT-RC2 lanes a CTA; a cluster above
constexpr int MAX_CLUSTER = 8;
constexpr int PIVOT_THREADS = 128;       // the pivot search up to this CTA size
constexpr int SMALL_THREADS = 256;       // CTAs launched with more registers a thread
constexpr int ROW_WORDS = 280;           // a warp's table: cum[257], then the pivots
constexpr int ROW_PIV = 260;
constexpr int STATIC_SMEM = 260 * 4 + 65536;  // L's CT-RC1 cum row and symbol table

// One shift_low of kernel A's (rc_encode.cuh), as selects (the steps stay
// branch-free): -> its packed event, 0 when it emits nothing.
__device__ __forceinline__ uint32_t shift_low(uint32_t& low, uint32_t& carry, uint32_t& cache,
                                              uint32_t& csize) {
  const bool out = low < 0xFF000000u || carry != 0;
  const uint32_t ev = 0x80000000u | (((cache + carry) & 0xFFu) << 23) | ((carry & 1u) << 22) |
                      ((csize - 1u) & EV_RUN_MASK);
  cache = out ? low >> 24 : cache;
  csize = out ? 1u : csize + 1u;
  carry = out ? 0u : carry;
  low <<= 8;
  return out ? ev : 0u;
}

// Up to SLOTS shift_lows while range < 2^24, as selects; e[] gets the
// events.
template <int SLOTS>
__device__ __forceinline__ void renorm_encode(uint32_t& low, uint32_t& carry, uint32_t& rng,
                                              uint32_t& cache, uint32_t& csize,
                                              uint32_t (&e)[SLOTS]) {
#pragma unroll
  for (int sl = 0; sl < SLOTS; ++sl) {
    const bool d = rng < RC_TOP;
    uint32_t l2 = low, c2 = carry, a2 = cache, s2 = csize;
    const uint32_t ev = shift_low(l2, c2, a2, s2);
    e[sl] = d ? ev : 0u;
    low = d ? l2 : low;
    carry = d ? c2 : carry;
    cache = d ? a2 : cache;
    csize = d ? s2 : csize;
    rng = d ? rng << 8 : rng;
  }
}

// The decoder's side: up to SLOTS bytes from the queue q (occ bytes, the
// oldest highest) into code while range < 2^24, as selects.
template <int SLOTS>
__device__ __forceinline__ void renorm_decode(uint32_t& code, uint32_t& rng, uint32_t& occ,
                                              uint64_t q) {
#pragma unroll
  for (int sl = 0; sl < SLOTS; ++sl) {
    const bool d = rng < RC_TOP;
    const uint32_t o = d ? occ - 1 : occ;
    const uint32_t byte = (uint32_t)(q >> (8 * o)) & 0xFFu;
    code = d ? (code << 8) | byte : code;
    rng = d ? rng << 8 : rng;
    occ = o;
  }
}

// floor(n / d) for d >= 1, given m = floor((2^32 - 1) / d). With r = 2^32 - 1
// - m*d < d, n*m / 2^32 = (n / d) * (1 - (1 + r) / 2^32) > n / d - n / 2^32
// > n / d - 1, so umulhi(n, m) is floor(n / d) or one less, and q*d <= n.
__device__ __forceinline__ uint32_t div_magic(uint32_t n, uint32_t d, uint32_t m) {
  const uint32_t q = __umulhi(n, m);
  return q + (n - q * d >= d ? 1u : 0u);
}

// A load of the table warp's progress counter that orders the reads after
// it (the table it announces) behind it.
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];\n"
               : "=r"(v)
               : "r"((uint32_t)__cvta_generic_to_shared(p))
               : "memory");
  return v;
}

// Warp: CT-RC2's rescale before a step (one halving when the total has
// reached the limit) of the split counts f (load_split).
__device__ __forceinline__ void rescale(uint32_t (&f)[8], uint32_t& total, uint32_t limit) {
  if (total >= limit) {
    uint32_t s = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      f[i] = (f[i] >> 1) | 1u;
      s += f[i];
    }
    total = __reduce_add_sync(FULL, s);
  }
}

// A warp's table is held split: lane l has the counts of symbols 4l..4l+3
// in f[0..3] and of 128+4l..128+4l+3 in f[4..7], so that a warp's 16-byte
// loads and stores of a 256-entry row (load_split, write_cum) cover 512
// contiguous bytes each: no bank conflict.
__device__ __forceinline__ void load_split(const uint32_t* row, uint32_t (&f)[8]) {
  const int lane = threadIdx.x & 31;
  const uint4 a = reinterpret_cast<const uint4*>(row)[lane];
  const uint4 b = reinterpret_cast<const uint4*>(row)[32 + lane];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

// Warp: the exclusive cum of the split counts into row[0..255] (16-byte
// aligned) and their sum into row[256]; c_lo, c_hi get cum[4l] and
// cum[128+4l].
__device__ __forceinline__ void write_cum(const uint32_t (&f)[8], uint32_t* row, uint32_t& c_lo,
                                          uint32_t& c_hi) {
  const int lane = threadIdx.x & 31;
  const uint32_t p1 = f[0] + f[1], p5 = f[4] + f[5];
  const uint32_t lo = p1 + (f[2] + f[3]), hi = p5 + (f[6] + f[7]);
  const uint32_t tot_lo = __reduce_add_sync(FULL, lo);
  uint32_t il = lo, ih = hi;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t yl = __shfl_up_sync(FULL, il, d);
    const uint32_t yh = __shfl_up_sync(FULL, ih, d);
    if (lane >= d) il += yl, ih += yh;
  }
  c_lo = il - lo;
  c_hi = tot_lo + ih - hi;
  uint4* r4 = reinterpret_cast<uint4*>(row);
  r4[lane] = make_uint4(c_lo, c_lo + f[0], c_lo + p1, c_lo + p1 + f[2]);
  r4[32 + lane] = make_uint4(c_hi, c_hi + f[4], c_hi + p5, c_hi + p5 + f[6]);
  if (lane == 31) row[256] = tot_lo + ih;
}

__device__ __forceinline__ uint32_t u4_at(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// ------------------------------------------------------------- kernel J

struct EncShared {
  uint32_t ring[RING][SLOT_WORDS];  // CT-RC2's tables; CT-RC1's in ring[0]
  // cumulative histograms of the rows, even rows in [0] and odd in [1]:
  // HIST_COPIES copies (a lane adds to copy lane & 7, so that equal bytes
  // of a warp spread over 8 addresses), active counts in copy 0
  uint32_t hist[2][HIST_COPIES][HIST_WORDS];
  uint8_t stage[2][STAGE_BYTES];    // tiles of x rows for the histogram warps
  int pub;                          // the last step whose table is in the ring
  int done[ENC_ADAPTIVE_LANES / 32];  // each coder warp's last step coded
};

// Copies n <= 16 bytes from src (16-byte aligned) to shared dst as part of
// the thread's open commit group; bytes past n are zero.
__device__ __forceinline__ void copy16_async(void* dst, const void* src, int n) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}

// Adds inc times a row's histogram, the growth of the cumulative `sum` (and
// active count `act`) since `seen` (`seen_act`), to the split counts f and
// their total; seen takes the new readings.
__device__ __forceinline__ void grow(uint32_t (&f)[8], uint32_t& total, const uint32_t (&sum)[8],
                                     uint32_t act, uint32_t (&seen)[8], uint32_t& seen_act,
                                     uint32_t inc) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    f[i] += inc * (sum[i] - seen[i]);
    seen[i] = sum[i];
  }
  total += inc * (act - seen_act);
  seen_act = act;
}

// CT-RC2's table warp (warp 0 of the producers): tables 0..stride-1 into
// the ring. Only shared memory, so that its fence before each publication
// waits on nothing but its own table stores. Row j's counts are the
// difference of the cumulative histogram [j & 1] from its last reading.
__device__ void build_tables(EncShared& sh, int stride, int ncw, int pthreads, uint32_t inc,
                             uint32_t limit) {
  const int lane = threadIdx.x & 31;
  // the cumulative histograms as last read: [0] even rows, [1] odd rows
  uint32_t f[8], seen0[8], seen1[8], act0 = 0, act1 = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = 1, seen0[i] = 0, seen1[i] = 0;
  uint32_t total = 256;
  int min_done = -1;
  for (int j = 0; j < stride; ++j) {
    if (j > 0) {
      // the histogram of row j - 1 is complete
      asm volatile("bar.sync 1, %0;" ::"r"(pthreads) : "memory");
      const int b = (j - 1) & 1;
      uint32_t sum[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
      for (int c = 0; c < HIST_COPIES; ++c) {
        uint32_t h[8];
        load_split(sh.hist[b][c], h);
#pragma unroll
        for (int i = 0; i < 8; ++i) sum[i] += h[i];
      }
      const uint32_t act = sh.hist[b][0][HIST_ACTIVE];
      if (b)
        grow(f, total, sum, act, seen1, act1, inc);
      else
        grow(f, total, sum, act, seen0, act0, inc);
    }
    rescale(f, total, limit);
    // the slot of step j is free once every coder warp is past j - RING
    while (min_done < j - RING) {
      const int d = lane < ncw ? *reinterpret_cast<volatile int*>(&sh.done[lane]) : INT_MAX;
      min_done = __reduce_min_sync(FULL, d);
    }
    uint32_t* slot = sh.ring[j % RING];
    const uint32_t mg = FULL / total;  // issued before the scan, beside it
    uint32_t c_lo, c_hi;
    write_cum(f, slot, c_lo, c_hi);
    if (lane == 0) {
      slot[SLOT_TOTAL] = total;
      slot[SLOT_MAGIC] = mg;
    }
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      *reinterpret_cast<volatile int*>(&sh.pub) = j;
    }
  }
}

// CT-RC2's histogram warps (hw = 0..H-1 of them): each row j < stride - 1
// into the cumulative histogram [j & 1], then barrier 1 with the table
// warp. Histogram lane ht takes the row's bytes ht + 32*H*k (a warp's
// instruction: 32 consecutive bytes) and adds to copy ht & 7. Up to
// STAGE_BYTES / K rows at a time come into stage[] through cp.async, a tile
// ahead; past K = STAGE_BYTES the rows are read in place.
__device__ void count_rows(EncShared& sh, const uint8_t* __restrict__ x,
                           const int32_t* __restrict__ lane_len, int K, int stride, int H,
                           int hw, int pthreads) {
  const int lane = threadIdx.x & 31, ht = hw * 32 + lane, step = 32 * H;
  int lmin = stride;  // below it every byte of the lane's share is active
  for (int i = ht; i < K; i += step) lmin = min(lmin, max(lane_len[i], 0));
  const bool staged = K <= STAGE_BYTES;
  const int tr = staged ? STAGE_BYTES / K : 1;  // rows a tile
  const size_t end = (size_t)stride * K;
  auto copy_tile = [&](int t) {
    const size_t base = (size_t)t * STAGE_BYTES;
    for (int c = ht; c < STAGE_BYTES / 16; c += step) {
      const size_t off = base + 16 * (size_t)c;
      if (off < end)
        copy16_async(sh.stage[t & 1] + 16 * c, x + off, (int)min((size_t)16, end - off));
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  if (staged) copy_tile(0);
  for (int j = 0; j + 1 < stride; ++j) {
    const uint8_t* row = x + (size_t)j * K;
    if (staged) {
      if (j % tr == 0) {
        // tile j / tr is in; the other buffer (the tile before) is free
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        if (H > 1)
          asm volatile("bar.sync 2, %0;" ::"r"(H * 32) : "memory");
        else
          __syncwarp();
        copy_tile(j / tr + 1);
      }
      row = sh.stage[(j / tr) & 1] + (j % tr) * K;
    }
    uint32_t* h = sh.hist[j & 1][ht & (HIST_COPIES - 1)];
    int act = 0;
#pragma unroll 8
    for (int i = ht; i < K; i += step) {
      if (j < lmin || j < min(max(lane_len[i], 0), stride)) {
        atomicAdd(&h[row[i]], 1u);
        ++act;
      }
    }
    act = __reduce_add_sync(FULL, act);
    if (lane == 0 && act) atomicAdd(&sh.hist[j & 1][0][HIST_ACTIVE], (uint32_t)act);
    asm volatile("bar.sync 1, %0;" ::"r"(pthreads) : "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// x [stride, K] u8 (16-byte aligned); lane_len [K] i32; freqs_in [256] i32
// (CT-RC1) or null; ev [SLOTS*stride + 2, K] u32. A CTA: `coders` coder
// threads (a lane each: lanes blockIdx.x*coders + tid), then, for CT-RC2,
// one table warp and H histogram warps.
template <int SLOTS, bool ADAPTIVE, int GROUP>
__global__ void __launch_bounds__(ENC_ADAPTIVE_LANES + (1 + MAX_HIST_WARPS) * 32)
    rc_exact_encode_kernel(const uint8_t* __restrict__ x, const int32_t* __restrict__ lane_len,
                           const int32_t* __restrict__ freqs_in, uint32_t* __restrict__ ev, int K,
                           int stride, int coders, int H, uint32_t inc, uint32_t limit) {
  __shared__ __align__(16) EncShared sh;
  const int tid = threadIdx.x;
  if (ADAPTIVE) {
    for (int i = tid; i < 2 * HIST_COPIES * HIST_WORDS; i += blockDim.x) (&sh.hist[0][0][0])[i] = 0;
    if (tid < ENC_ADAPTIVE_LANES / 32) sh.done[tid] = tid < (coders >> 5) ? -1 : INT_MAX;
    if (tid == 0) sh.pub = -1;
  } else if (tid < 32) {
    uint32_t f[8], c_lo, c_hi;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = (uint32_t)freqs_in[4 * tid + i], f[4 + i] = (uint32_t)freqs_in[128 + 4 * tid + i];
    write_cum(f, sh.ring[0], c_lo, c_hi);
  }
  __syncthreads();
  if (tid >= coders) {
    if (ADAPTIVE) {
      const int w = (tid - coders) >> 5, pthreads = (1 + H) * 32;
      if (w == 0)
        build_tables(sh, stride, coders >> 5, pthreads, inc, limit);
      else
        count_rows(sh, x, lane_len, K, stride, H, w - 1, pthreads);
    }
    return;
  }

  const int lane = blockIdx.x * coders + tid, warp = tid >> 5;
  const bool has = lane < K;
  const int len = has ? min(max(lane_len[lane], 0), stride) : 0;
  uint32_t low = 0, carry = 0, rng = FULL, cache = 0, csize = 1;
  int seen = -1;

  // a group's GROUP symbols, loaded together a group ahead (two groups in
  // turn, so that a step never waits on a load issued after its own)
  auto load = [&](uint32_t (&xs)[GROUP], int j0) {
#pragma unroll
    for (int u = 0; u < GROUP; ++u) xs[u] = j0 + u < len ? x[(size_t)(j0 + u) * K + lane] : 0u;
  };
  auto code = [&](const uint32_t (&xs)[GROUP], int j0) {
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      const int j = j0 + u;
      if (j >= stride) break;
      const uint32_t* tab = sh.ring[0];
      uint32_t total = STATIC_TOTAL, mg = 0;
      if (ADAPTIVE) {
        if (j > seen) {
          int pb;
          while ((pb = ld_acquire(&sh.pub)) < j) {
          }
          seen = pb;
        }
        tab = sh.ring[j % RING];
        total = tab[SLOT_TOTAL];
        mg = tab[SLOT_MAGIC];
      }
      uint32_t e[SLOTS];
#pragma unroll
      for (int sl = 0; sl < SLOTS; ++sl) e[sl] = 0;
      if (j < len) {
        const uint32_t s = xs[u];
        const uint32_t c = tab[s];
        const uint32_t f = tab[s + 1] - c;
        const uint32_t t = ADAPTIVE ? div_magic(rng, total, mg) : rng >> 16;
        const uint32_t add = t * c;
        const uint32_t nl = low + add;
        carry |= nl < low ? 1u : 0u;
        low = nl;
        rng = (c + f == total) ? rng - add : t * f;
        renorm_encode<SLOTS>(low, carry, rng, cache, csize, e);
      }
      if (has) {
        uint32_t* evj = ev + (size_t)j * SLOTS * K + lane;
#pragma unroll
        for (int sl = 0; sl < SLOTS; ++sl) evj[(size_t)sl * K] = e[sl];
      }
    }
    if (ADAPTIVE) {
      // this warp's reads of the slots up to j0 + GROUP - 1 have returned:
      // the table warp may reuse them
      __syncwarp();
      if ((tid & 31) == 0) *reinterpret_cast<volatile int*>(&sh.done[warp]) = j0 + GROUP - 1;
    }
  };
  uint32_t xa[GROUP], xb[GROUP];
  load(xa, 0);
  load(xb, GROUP);
  for (int j0 = 0; j0 < stride; j0 += 2 * GROUP) {
    code(xa, j0);
    load(xa, j0 + 2 * GROUP);
    if (j0 + GROUP >= stride) break;
    code(xb, j0 + GROUP);
    load(xb, j0 + 3 * GROUP);
  }

  // flush: round low up to a multiple of 2^24, then shift_low twice
  if (!has) return;
  uint32_t* fl0 = ev + (size_t)SLOTS * stride * K;
  const uint32_t nl = low + ((0u - low) & 0xFFFFFFu);
  carry |= nl < low ? 1u : 0u;
  low = nl;
  fl0[lane] = shift_low(low, carry, cache, csize);
  fl0[K + lane] = shift_low(low, carry, cache, csize);
}

// ------------------------------------------------------------- kernel L

// words [l4, K] u32 big-endian word rows (l4 >= 1); lane_len [K] i32;
// freqs_in [256] i32; out [K*stride] u8 (0 where j >= lane_len). A
// thread a lane, lanes blockIdx.x*blockDim.x + tid; dynamic shared memory:
// the cum row, then sym[2^16].
template <int SLOTS>
__global__ void __launch_bounds__(DEC_STATIC_THREADS)
    rc_static_decode_kernel(const uint32_t* __restrict__ words, const int32_t* __restrict__ lane_len,
                            const int32_t* __restrict__ freqs_in, uint8_t* __restrict__ out, int K,
                            int l4, int stride) {
  extern __shared__ __align__(16) uint32_t dsm[];
  uint32_t* cum = dsm;
  uint8_t* sym = reinterpret_cast<uint8_t*>(dsm + 260);
  const int tid = threadIdx.x, bd = blockDim.x;
  if (tid < 32) {
    uint32_t f[8], c_lo, c_hi;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = (uint32_t)freqs_in[4 * tid + i], f[4 + i] = (uint32_t)freqs_in[128 + 4 * tid + i];
    write_cum(f, cum, c_lo, c_hi);
  }
  __syncthreads();
  // sym[v] = the largest s with cum[s] <= v: symbol s's slots, s = 255's up
  // to 2^16
  for (int s = 0; s < 256; ++s) {
    const uint32_t c = cum[s], e = s == 255 ? STATIC_TOTAL : min(cum[s + 1], STATIC_TOTAL);
    for (uint32_t v = c + tid; v < e; v += bd) sym[v] = (uint8_t)s;
  }
  __syncthreads();
  const int lane = blockIdx.x * bd + tid;
  if (lane >= K) return;
  const int len = min(max(lane_len[lane], 0), stride);
  uint32_t rng = FULL, code = words[lane], occ = 0, widx = 1;
  uint64_t q = 0;  // the queued bytes, the oldest highest, occ of them
  // the next two words (widx, widx + 1), loaded early
  uint32_t nw0 = 1 < l4 ? words[(size_t)K + lane] : 0u;
  uint32_t nw1 = 2 < l4 ? words[(size_t)2 * K + lane] : 0u;
  for (int j = 0; j < len; ++j) {
    if (occ < (uint32_t)SLOTS) {
      q = (q << 32) | nw0;
      occ += 4;
      ++widx;
      nw0 = nw1;
      nw1 = widx + 1 < (uint32_t)l4 ? words[(size_t)(widx + 1) * K + lane] : 0u;
    }
    const uint32_t t = rng >> 16;
    uint32_t v = code / t;
    v = v < STATIC_TOTAL - 1 ? v : STATIC_TOTAL - 1;
    const uint32_t s = sym[v];
    const uint32_t c = cum[s];
    const uint32_t f = cum[s + 1] - c;
    code -= t * c;
    rng = (c + f == STATIC_TOTAL) ? rng - t * c : t * f;
    renorm_decode<SLOTS>(code, rng, occ, q);
    out[(size_t)j * K + lane] = (uint8_t)s;
  }
  for (int j = len; j < stride; ++j) out[(size_t)j * K + lane] = 0;
}

// CT-RC2 decode: a CTA holds lanes blockIdx.x*blockDim.x*LPT + m*blockDim.x
// + tid (m < LPT); G CTAs (a cluster when G > 1) make the stream. Arguments
// as for CT-RC1's, with inc and limit = 2^limit_log2 for the table.
template <int LPT, int SLOTS, bool PIVOTS, int MAXT>
__global__ void __launch_bounds__(MAXT, 1)
    rc_adaptive_decode_kernel(const uint32_t* __restrict__ words,
                              const int32_t* __restrict__ lane_len, uint8_t* __restrict__ out,
                              int K, int l4, int stride, uint32_t inc, uint32_t limit, int G) {
  // words a lane loads early: none in small CTAs (measured faster there)
  constexpr int AH = MAXT <= SMALL_THREADS ? 0 : LPT == 1 ? 2 : LPT == 2 ? 1 : 0;
  // cumulative histograms: step j's adds go to [j & 1], whose growth since
  // a warp last read it is step j's histogram; active lanes at HIST_ACTIVE
  __shared__ __align__(16) uint32_t hist[2][HIST_WORDS];
  __shared__ __align__(16) uint32_t rows[32][ROW_WORDS];  // each warp's table
  const int tid = threadIdx.x, bd = blockDim.x, ln = tid & 31;
  uint32_t* row = rows[tid >> 5];
  for (int i = tid; i < 2 * HIST_WORDS; i += bd) (&hist[0][0])[i] = 0;

  uint32_t rng[LPT], code[LPT], ow[LPT], nw0[LPT], nw1[LPT];  // ow: occ << 29 | widx
  uint64_t q[LPT];
  int len[LPT];
#pragma unroll
  for (int m = 0; m < LPT; ++m) {
    const int lane = blockIdx.x * bd * LPT + m * bd + tid;
    const bool has = lane < K;
    len[m] = has ? min(max(lane_len[lane], 0), stride) : 0;
    rng[m] = FULL;
    code[m] = has ? words[lane] : 0u;
    q[m] = 0;
    ow[m] = 1;
    nw0[m] = AH >= 1 && has && 1 < l4 ? words[(size_t)K + lane] : 0u;
    nw1[m] = AH >= 2 && has && 2 < l4 ? words[(size_t)2 * K + lane] : 0u;
  }
  __syncthreads();
  // the counts of the table (split), the same in every warp
  uint32_t fc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) fc[i] = 1;
  // the table's total and magic number, the same in every lane
  uint32_t total = 256, mg = 0, seen0[8] = {}, seen1[8] = {}, act0 = 0, act1 = 0;
  auto publish = [&]() {
    rescale(fc, total, limit);
    mg = FULL / total;  // issued before the scan, beside it
    uint32_t c_lo, c_hi;
    write_cum(fc, row, c_lo, c_hi);
    if (PIVOTS && !(ln & 3)) {  // the pivots cum[16i]
      row[ROW_PIV + (ln >> 2)] = c_lo;
      row[ROW_PIV + 8 + (ln >> 2)] = c_hi;
    }
    __syncwarp();
  };
  publish();

  for (int j = 0; j < stride; ++j) {
    uint32_t* h = hist[j & 1];
    const uint32_t T = total;
    uint4 pv[4];
    if (PIVOTS) {
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = reinterpret_cast<const uint4*>(row + ROW_PIV)[i];
    }
    int act = 0;
#pragma unroll
    for (int m = 0; m < LPT; ++m) {
      const int lane = blockIdx.x * bd * LPT + m * bd + tid;
      const bool on = j < len[m];
      uint32_t s = 0;
      if (on) {
        uint32_t occ = ow[m] >> 29, widx = ow[m] & 0x1FFFFFFFu;
        if (occ < (uint32_t)SLOTS) {
          uint32_t w;
          if (AH == 0) {
            w = widx < (uint32_t)l4 ? words[(size_t)widx * K + lane] : 0u;
          } else {
            w = nw0[m];
            if (AH == 2) nw0[m] = nw1[m];
            const uint32_t nx = widx + AH;
            const uint32_t nv = nx < (uint32_t)l4 ? words[(size_t)nx * K + lane] : 0u;
            if (AH == 2)
              nw1[m] = nv;
            else
              nw0[m] = nv;
          }
          q[m] = (q[m] << 32) | w;
          occ += 4;
          ++widx;
        }
        const uint32_t t = div_magic(rng[m], T, mg);
        const uint32_t cd = code[m];
        if (PIVOTS) {
          uint32_t cnt = 0;
#pragma unroll
          for (int i = 1; i < 16; ++i) cnt += t * u4_at(pv[i >> 2], i & 3) <= cd ? 1u : 0u;
          s = cnt << 4;
#pragma unroll
          for (uint32_t b = 8; b; b >>= 1)
            if (t * row[s + b] <= cd) s += b;
        } else {
#pragma unroll
          for (uint32_t b = 128; b; b >>= 1)
            if (t * row[s + b] <= cd) s += b;
        }
        const uint32_t c = row[s];
        const uint32_t f = row[s + 1] - c;
        uint32_t nc = cd - t * c;
        uint32_t r = (c + f == T) ? rng[m] - t * c : t * f;
        renorm_decode<SLOTS>(nc, r, occ, q[m]);
        code[m] = nc;
        rng[m] = r;
        ow[m] = occ << 29 | widx;
      }
      if (lane < K) out[(size_t)j * K + lane] = (uint8_t)s;
      if (on) atomicAdd(&h[s], 1u);
      act += __popc(__ballot_sync(FULL, on));
    }
    if (ln == 0 && act) atomicAdd(&h[HIST_ACTIVE], (uint32_t)act);
    if (j + 1 == stride) break;

    // every lane's step-j symbol is in: table j + 1
    if (G > 1)
      cg::this_cluster().sync();
    else
      __syncthreads();
    uint32_t sum[8] = {}, a = 0;
    for (int r = 0; r < G; ++r) {
      const uint32_t* hr = G > 1 ? cg::this_cluster().map_shared_rank(h, r) : h;
      uint32_t hc[8];
      load_split(hr, hc);
      a += hr[HIST_ACTIVE];
#pragma unroll
      for (int i = 0; i < 8; ++i) sum[i] += hc[i];
    }
    if (j & 1)
      grow(fc, total, sum, a, seen1, act1, inc);
    else
      grow(fc, total, sum, a, seen0, act0, inc);
    publish();
  }
  // no CTA leaves while another may still read its histogram
  if (G > 1) cg::this_cluster().sync();
}

// ---------------------------------------------------------- launching

__host__ inline int round32(int k) { return (k + 31) & ~31; }

template <int SLOTS, bool ADAPTIVE, int GROUP>
cudaError_t launch_encode(const void* x, const void* lane_len, const void* freqs, void* ev, int K,
                          int stride, uint32_t inc, uint32_t limit, cudaStream_t stream) {
  const int most = !ADAPTIVE ? ENC_STATIC_LANES
                   : K <= ENC_SMALL_K ? ENC_ADAPTIVE_SMALL : ENC_ADAPTIVE_LANES;
  const int coders = K >= most ? most : round32(K);
  const int ctas = (K + coders - 1) / coders;
  // histogram warps: one for each 64 lanes (up to 2 bytes of a row a lane)
  // up to 8 warps
  const int H = K <= 64 ? 1 : K <= 128 ? 2 : K <= 256 ? 4 : MAX_HIST_WARPS;
  rc_exact_encode_kernel<SLOTS, ADAPTIVE, GROUP>
      <<<ctas, coders + (ADAPTIVE ? (1 + H) * 32 : 0), 0, stream>>>(
          (const uint8_t*)x, (const int32_t*)lane_len, (const int32_t*)freqs, (uint32_t*)ev, K,
          stride, coders, H, inc, limit);
  return cudaGetLastError();
}

cudaError_t launch_static_decode(const void* words, const void* lane_len, const void* freqs,
                                 void* out, int K, int l4, int stride, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rc_static_decode_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize, STATIC_SMEM);
  if (err != cudaSuccess) return err;
  const int threads = K >= DEC_STATIC_THREADS ? DEC_STATIC_THREADS : round32(K);
  rc_static_decode_kernel<2><<<(K + threads - 1) / threads, threads, STATIC_SMEM, stream>>>(
      (const uint32_t*)words, (const int32_t*)lane_len, (const int32_t*)freqs, (uint8_t*)out, K,
      l4, stride);
  return cudaGetLastError();
}

template <int LPT, int SLOTS, bool PIVOTS, int MAXT>
cudaError_t launch_adaptive_decode(const void* words, const void* lane_len, void* out, int K,
                                   int l4, int stride, uint32_t inc, uint32_t limit, int G,
                                   int threads, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = G;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = G > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, rc_adaptive_decode_kernel<LPT, SLOTS, PIVOTS, MAXT>,
                                       (const uint32_t*)words, (const int32_t*)lane_len,
                                       (uint8_t*)out, K, l4, stride, inc, limit, G);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// CT-RC1 when freqs is not null (slots 2; inc and limit_log2 unused), else
// CT-RC2 (slots 2 or 3). K a power of two up to 65,536. Returns the
// cudaError_t as an int (cudaErrorInvalidValue for what it does not take).
extern "C" int ct_rc_exact_encode(const void* x, const void* lane_len, const void* freqs, void* ev,
                                  int K, int stride, int inc, int limit_log2, int slots,
                                  void* stream) {
  if (K < 1 || K > 65536 || (K & (K - 1)) || stride < 0 || limit_log2 < 0 || limit_log2 > 31)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const uint32_t u = (uint32_t)inc, limit = 1u << limit_log2;
  if (freqs != nullptr)
    return slots == 2 ? (int)launch_encode<2, false, AHEAD>(x, lane_len, freqs, ev, K, stride, 0, 0, st)
                      : (int)cudaErrorInvalidValue;
#define CT_RC_ENC(S)                                                                       \
  (K <= ENC_SMALL_K                                                                        \
       ? launch_encode<S, true, AHEAD_SMALL>(x, lane_len, nullptr, ev, K, stride, u, limit, st) \
       : launch_encode<S, true, AHEAD>(x, lane_len, nullptr, ev, K, stride, u, limit, st))
  if (slots == 2) return (int)CT_RC_ENC(2);
  if (slots == 3) return (int)CT_RC_ENC(3);
#undef CT_RC_ENC
  return (int)cudaErrorInvalidValue;
}

extern "C" int ct_rc_exact_decode(const void* words, const void* lane_len, const void* freqs,
                                  void* out, int K, int l4, int stride, int inc, int limit_log2,
                                  int slots, void* stream) {
  if (K < 1 || K > 65536 || (K & (K - 1)) || l4 < 1 || stride < 0 || limit_log2 < 0 ||
      limit_log2 > 31)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (freqs != nullptr)
    return slots == 2 ? (int)launch_static_decode(words, lane_len, freqs, out, K, l4, stride, st)
                      : (int)cudaErrorInvalidValue;
  const int G = K > DEC_CTA_LANES ? min(K / DEC_CTA_LANES, MAX_CLUSTER) : 1;
  const int kc = K / G;
  const int threads = kc >= 1024 ? 1024 : round32(kc);
  const int lpt = kc > 1024 ? kc / 1024 : 1;
  const uint32_t u = (uint32_t)inc, limit = 1u << limit_log2;
  // the pivot count pays where a CTA has few warps (so few table copies);
  // CTAs of up to SMALL_THREADS get registers past 64 a thread
  const bool piv = lpt <= 2 && threads <= PIVOT_THREADS, small = threads <= SMALL_THREADS;
#define CT_RC_DEC(L, S, P, M) \
  launch_adaptive_decode<L, S, P, M>(words, lane_len, out, K, l4, stride, u, limit, G, threads, st)
#define CT_RC_DEC_SMALL(L, S)                                                    \
  (small ? (piv ? CT_RC_DEC(L, S, true, SMALL_THREADS) : CT_RC_DEC(L, S, false, SMALL_THREADS)) \
         : CT_RC_DEC(L, S, false, 1024))
  switch (lpt * 4 + slots) {
    case 6: return (int)CT_RC_DEC_SMALL(1, 2);
    case 7: return (int)CT_RC_DEC_SMALL(1, 3);
    case 10: return (int)CT_RC_DEC_SMALL(2, 2);
    case 11: return (int)CT_RC_DEC_SMALL(2, 3);
    case 18: return (int)CT_RC_DEC(4, 2, false, 1024);
    case 19: return (int)CT_RC_DEC(4, 3, false, 1024);
    case 34: return (int)CT_RC_DEC(8, 2, false, 1024);
    case 35: return (int)CT_RC_DEC(8, 3, false, 1024);
  }
#undef CT_RC_DEC_SMALL
#undef CT_RC_DEC
  return (int)cudaErrorInvalidValue;
}
