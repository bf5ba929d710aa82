// Kernel G: CT-ANS1 v2 (interleaved rANS) decode on Hopper.
//
// Replaces the Pallas kernel cpprcoder_tpu/ops/rans_pallas.py:225
// `_decode_kernel` (pallas_call at rans_pallas.py:293).
//
// What it computes: per lane, from its final encoder state, for each step
// j < lane_len[i]: slot = st & (2^14 - 1), the symbol s that owns slot,
// st = f[s] * (st >> 14) + slot - cum[s], and one u16 refill
// st = (st << 16) | word when st < 2^16, the word taken at the lane's
// cursor in its row (0 past the row's end, as rans_ref.rans_decode reads).
// Symbol j of lane i goes to out[j*K + i], the original byte order.
//
// Design: lanes are independent (static table): one thread per lane,
// THREADS-thread blocks. A lane's steps are one dependent chain, so the
// design shortens the chain and takes everything else off it.
// - Tables. Each block first fills tables of 2^14 slots in shared memory:
//   f[s] and slot - cum[s] (u16 each) and s (u8) of the symbol s that owns
//   the slot. Warp w fills the runs of slots [cum[s], cum[s] + f[s]) of the
//   symbols s = w (mod warps) (2^14 stores a table, where a search a slot
//   would read cum 8 times). The step reads f and slot - cum at one offset
//   (two loads issued together), so its chain is one shared read, one
//   IMAD, a compare and a select: st = f * (st >> 14) + (slot - cum[s]).
//   The symbol's read only feeds the output byte.
// - Words. The lanes of a warp refill at different steps, so a step has no
//   branch: it selects between the state and its refill, whose word it
//   has read from shared memory beside its table reads, and the next slot
//   between the two values' low bits. Each lane holds RING words in a ring
//   in shared memory (word w in slot w % RING), fed by cp.async: the loop
//   runs in blocks of STEPS steps, and step i of a block copies word
//   w + DIST + i (w: the lane's next word at the block's start), one commit
//   group a block; the read and the copy issue while the table reads are
//   in flight. A block starts by waiting for the copies of all but the last
//   WAIT blocks, which hold every word it can reach (at most STEPS refills
//   a block). A copy may repeat a word already copied (the same bytes into
//   the same slot, which no step reads then); copies past l2 fill zeros
//   and read nothing.
// Where the Pallas kernel searched a 16x16 table with one-hot compares and
// summed a one-hot column for the refill, this reads both directly.
//
// What bounds it: by bytes, the word rows read once and one output byte a
// symbol (kennedy.xls: about 2 MB, 0.6 us at 3.35 TB/s). In fact each lane
// is one dependent chain of steps, and a call is latency-bound per step: a
// single lane of n symbols takes n steps whatever the card.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t ANS_PROB_BITS = 14;
constexpr uint32_t ANS_TOTAL = 1u << ANS_PROB_BITS;
constexpr uint32_t ANS_LOW = 1u << 16;
constexpr uint32_t OFF_MASK = (ANS_TOTAL - 1u) << 1;  // a slot's byte offset in a u16 table
constexpr int THREADS = 128;
constexpr int RING = 64;         // words a lane holds in shared memory (a power of two)
constexpr int STEPS = RING >= 32 ? 8 : RING / 4;  // steps a block of the loop
constexpr int DIST = RING - STEPS;
// copy groups a block start leaves in flight: the copies WAIT + 1 blocks
// back hold every word the block can reach (STEPS refills and the next
// word), since (WAIT + 1) * STEPS < DIST
constexpr int WAIT = (DIST - 1) / STEPS - 1;
static_assert(WAIT >= 0 && (WAIT + 1) * STEPS < DIST, "the ring holds a block's reach");

// dynamic shared memory: two u16 tables of f and slot - cum (64 KB), one
// u8 table of s (16 KB), the ring
constexpr size_t SYM_AT = 2 * ANS_TOTAL * 2;
constexpr size_t RING_AT = SYM_AT + ANS_TOTAL;
constexpr size_t SMEM_BYTES = RING_AT + RING * THREADS * 4;

// Copies the 4 bytes at src into shared dst without waiting (zeros, and no
// read, unless ok). No memory clobber: nothing reads dst before a later
// wait_group, which has one, so the compiler may place the copy among the
// step's loads.
__device__ __forceinline__ void copy_word_async(uint32_t* dst, const int32_t* src, bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}

// v, opaque to the compiler: keeps two selects' operands from being folded
// into one select before a shift and a mask, which would put both on the
// state's chain.
__device__ __forceinline__ uint32_t opaque(uint32_t v) {
  asm("" : "+r"(v));
  return v;
}

__device__ __forceinline__ uint32_t u16_at(const uint8_t* base, uint32_t byte_off) {
  return *reinterpret_cast<const uint16_t*>(base + byte_off);
}

// states [K] u32; rows [l2, K] i32 (u16 word values, zero past each lane's
// count); lane_len [K] i32; freq, cum [256] i32; out [stride, K] u8.
__global__ void __launch_bounds__(THREADS) rans_decode_kernel(const uint32_t* __restrict__ states,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ lane_len,
    const int32_t* __restrict__ freq, const int32_t* __restrict__ cum,
    uint8_t* __restrict__ out, int K, int l2, int stride) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* ftab = reinterpret_cast<uint16_t*>(smem);
  uint16_t* btab = ftab + ANS_TOTAL;
  uint8_t* s8 = smem + SYM_AT;
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + RING_AT);  // slot k of thread t: ring[k * THREADS + t]
  __shared__ uint32_t fs[256], cs[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    fs[i] = (uint32_t)freq[i];
    cs[i] = (uint32_t)cum[i];
  }
  __syncthreads();
  // warp w fills the runs of the symbols s = w (mod warps); a table that
  // does not sum to 2^14 leaves slots unset, and writes nothing out of range
  const int lid = threadIdx.x & 31;
  for (int s = threadIdx.x >> 5; s < 256; s += THREADS / 32) {
    const uint32_t c = cs[s], f = fs[s];
    const uint32_t end = c < ANS_TOTAL ? min(c + f, ANS_TOTAL) : 0u;
    for (uint32_t slot = c + lid; slot < end; slot += 32) {
      ftab[slot] = (uint16_t)f;
      btab[slot] = (uint16_t)(slot - c);
      s8[slot] = (uint8_t)s;
    }
  }
  __syncthreads();

  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= K) return;
  const int len = min(lane_len[lane], stride);
  const int32_t* col = rows + lane;  // word w of the lane: col[w * K]
  uint8_t* o = out + lane;           // step j of the lane: o[j * K]
  uint32_t* mine = ring + threadIdx.x;
  uint32_t st = states[lane];
  uint32_t off = (st << 1) & OFF_MASK;  // the slot's byte offset in a u16 table
  int widx = 0;                         // the lane's next word
  for (int v = 0; v < DIST; ++v)
    copy_word_async(mine + v * THREADS, v < l2 ? col + (size_t)v * K : col, v < l2);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  // A block of n <= STEPS steps from step j. It first waits until the
  // copies of all but the last WAIT blocks have landed; then step i copies
  // word w + DIST + i (w: the lane's next word at the block's start), one
  // commit group a block. In a step the table reads come first, then the
  // work off the chain (the lane's next word read beside them, the copy),
  // so that it can issue while they are in flight, then the chain. Ring
  // slots are addressed by byte offsets from the lane's slot 0.
  constexpr uint32_t SLOT = THREADS * 4, RING_MASK = RING * SLOT - 1;
  uint8_t* ring0 = reinterpret_cast<uint8_t*>(mine);
  uint32_t roff = 0;  // the slot of word widx
  auto block = [&](int j, int n) {
    const int w0 = widx + DIST;
    const int left = l2 - w0;                   // words of the row from w0 on
    const int32_t* src = col + (size_t)w0 * K;  // word w0 + i: src + i * K
    const uint32_t coff = (uint32_t)(w0 & (RING - 1)) * SLOT;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(WAIT) : "memory");
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      if (i < n) {
        // the table reads: f and slot - cum, the symbol
        const uint32_t s = s8[off >> 1];
        const uint32_t f = u16_at(smem, off);
        const uint32_t b = u16_at(reinterpret_cast<const uint8_t*>(btab), off);
        // off the chain: the lane's next word (landed: within this block's
        // reach), and one copy
        const uint32_t nextw = *reinterpret_cast<const uint32_t*>(ring0 + roff);
        const uint32_t noff = opaque((nextw << 1) & OFF_MASK);
        copy_word_async(reinterpret_cast<uint32_t*>(ring0 + ((coff + i * SLOT) & RING_MASK)),
                        i < left ? src : col, i < left);
        src += K;
        // the chain
        const uint32_t x = f * (st >> ANS_PROB_BITS) + b;  // the state before its refill
        const bool need = x < ANS_LOW;
        st = need ? (x << 16) | nextw : x;
        off = need ? noff : (x << 1) & OFF_MASK;
        widx += need ? 1 : 0;
        roff = need ? (roff + SLOT) & RING_MASK : roff;
        o[(size_t)(j + i) * K] = (uint8_t)s;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  int j = 0;
  for (; j + STEPS <= len; j += STEPS) block(j, STEPS);
  if (j < len) block(j, len - j);
  // no copy is left in flight into a block's shared memory past its end
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace

// The tables and the ring take 112 KB of dynamic shared memory, above the
// 48 KB a launch may take without opting in: a refused opt-in or launch
// returns its error.
extern "C" int ct_rans_decode(const void* states, const void* rows, const void* lane_len,
                              const void* freq, const void* cum, void* out, int K, int l2,
                              int stride, void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      rans_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  rans_decode_kernel<<<(K + THREADS - 1) / THREADS, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const uint32_t*)states, (const int32_t*)rows, (const int32_t*)lane_len,
      (const int32_t*)freq, (const int32_t*)cum, (uint8_t*)out, K, l2, stride);
  return (int)cudaGetLastError();
}
