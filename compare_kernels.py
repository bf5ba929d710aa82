#!/usr/bin/env python3
"""Time the port's kernels against another tree's, and variants of them,
on one GPU, in one process.

    python3 compare_kernels.py --base DIR [--variants NAME,...] [--sass]
                               [--profile KERNEL] [--only LETTERS] [--reps N]
                               [--out FILE]

DIR holds another checkout of the repository (for example the parent
commit, unpacked with `git archive` into an ignored directory such as
build/parent). Its `cpprcoder_tpu_torch/csrc/` and this tree's, and each
named variant of this tree's (a small edit of its sources, VARIANTS below),
are built with the same nvcc flags into libraries of their own under
build/compare/ (the entry points keep their names; ctypes loads each
library apart). Inputs are made at the main paths' shapes (chip_smoke.py's
corpus files) through this tree's wrappers; then every library runs each
kernel on them, in turns (base, this tree, variants, then the reverse
order; the lower of a library's two turns counts), each turn 10 launches
after 2 warm-up ones, queued behind a spin of the stream (so the card runs
them back to back) and timed with CUDA events; kernels B and H also
through their wrappers, whose host work stays in their time (50 calls a
turn, each timed apart, the median counts). Every output must equal
this tree's: a library that differs, or refuses a shape, is reported so.

--sass compares the SASS of kernel D (the one-row instantiations of
rc_encode_kernel) in the base library with this tree's (cuobjdump; the
instructions, the function names aside).

--only LETTERS (for example JL) times those kernels alone.

--profile KERNEL (a letter) runs that kernel's cases through this tree's
library under torch.profiler and reports each of its launches' mean device
time by name (a kernel's passes, and a memset, apart).

Kernels M and N (CT-MTF1 encode and decode) are timed at the pipeline's
mtf1 stage of kennedy.xls (its BWT, made on the card by this tree's
blocksort: 32 blocks), plain MTF over kennedy.xls, and the mtf1 stage of
grammar.lsp (one block of 3,738 bytes); their outputs are compared over
the n bytes that carry data.

Kernels J and L (CT-RC1/CT-RC2 encode and decode) are timed at
adaptive_range and static_range over kennedy.xls (K = 256), the
pipeline's coder stage there (K = 64), the 11 files concatenated (K =
1,024, three slots), grammar.lsp (K = 2), adaptive_range over kennedy.xls
at 8,192 lanes (L a cluster of 2, or one CTA where a variant says so) and at
65,536 (a tree from before the lane cap was lifted refuses it), each at
the codec's defaults and the slot count of this tree's `range_ops.slots`.

Kernel P (CT-LZ4's parse walk) is timed at the same six shapes as Q and R
below, from this tree's match table: as its device work queued back to
back and through a wrapper of each interface (50 calls, each timed apart,
allocations included). A library whose P takes step and off (one launch,
int32 exits in global memory; its source says `ct_lz_walk(const void*
step`) is called with lz_ops.walk_inputs' tensors made inside each call and
its outputs zeroed, as its wrapper did (OLD_WALK_SIGNATURE); the matches,
offsets, lengths, zeros past the counts and the counts are compared.

Kernels Q and R (CT-LZ4's serializer and decode) are timed at kennedy.xls,
grammar.lsp, fields.c at seg_log2 7, 70,000 zero bytes, 200,000 random
bytes and the first 2^14-byte superblock of CT-SB over the concatenated
corpus, their inputs made by this tree's kernels P and Q. A library whose Q
is three launches with a cumsum between them (ct_lz_clamp, ct_lz_sizes,
ct_lz_write) and whose R is one launch is called through those entry
points (OLD_LZ_SIGNATURES). Q is timed as its launches alone (that
library's grid width and payload length read beforehand) and through a
wrapper of each interface (its host reads inside; 50 calls, each timed
apart); the blocks and sizes are compared, not the padding.

Kernel Z (CT-LZ4's v1 match table) is timed at kennedy.xls, grammar.lsp,
fields.c at seg_log2 7, 70,000 zero bytes, 200,000 random bytes and
kennedy.xls at seg_log2 20 (`--only Z`), its launches queued back to back,
beside its plain version (lz_ops.match_table_v1) and v2's tensor table
(lz_ops.match_table) at the same shapes, each call of those timed apart. A
tree without Z (no lz_match.cu) skips it. Its diagnostics skip a step
(their outputs differ): `zdiag_noscan` the window scan, `zdiag_nosort` the
sort, `zdiag_nolcp` the byte compares. A base whose Z is its first design
(a bitonic sort in shared memory, as 3b1a96c's) times it against this
tree's (Z's block merge sort, csrc/lz_sort.cuh) in the same call.

Kernel K (CT-LZ4's v2 match table) is timed at Z's six shapes and ptt5
(`--only K`): its launches queued back to back into buffers allocated
once, and through a wrapper that allocates its outputs and scratch in each
call as lz_kernels.match_v2 does (50 calls, each timed apart), beside its
plain version (v2's tensor table, lz_ops.match_table). Every library gets
this tree's scratch (lz_kernels.match_v2_scratch), which covers an older
K's. A tree without K (no lz_match_v2.cu) skips it. `--profile K` names
its launches (the memset, k_count, k_zero, k_alloc, k_scatter, k_sort,
k_fix, the merge passes summed, k_al, k_ladder, k_pick, k_out). Its
diagnostics skip a step (their outputs differ): `kdiag_nosort` the tile
sort, the crossing groups' merges and the merge passes (each group then
in the scatter's order), `kdiag_noladder` the ladder launch,
`kdiag_nopick` the pick launch. Its geometry variants: `k_cap2048` sorts
tiles of 2,048 keys (this tree's 4,096): the groups past a tile take the
merge passes; `k_wide` sorts the wide keys (a 5-word key) at every W,
where this tree packs them into 16 bytes up to W = 2^20.

Kernels S, T (CT-ASE1 encode and decode) and U, V (CT-RC3's) are timed at
kennedy.xls (K = 256), alice29.txt (K = 64), grammar.lsp (K = 2) and the
first 2^14-byte superblock of CT-SB over the concatenated corpus (K = 8),
and U and V also at kennedy.xls over 2,048 lanes (V's lanes in turns,
their state in scratch) and 65,536 (the u32 table), at the codec's
defaults, their inputs made by this tree's S and U (`--only STUV`; T and
V alone with `--only TV`). U is timed once more at kennedy.xls with its
two passes alternating over chunks of U_SMALL_CHUNK steps, so that the
chunk edges are timed, and at lcet10.txt (K = 128). U takes the chunked
interface of this tree (triples, model scratch and chunk): a tree whose U
is one kernel is refused for U. V's state scratch is sized for either
tree. The `vdiag2_*` and `tdiag2_*` variants take one
part of a step out of this tree's V and T; their outputs differ by design,
so the script exits 1 with them. `o1_rows_contiguous` and
`o1_rows_rotated` build U and V with the rescale's rows shared out over
the warps otherwise.

Kernels W, X and Y (CT-ANS2's model, coder and decode) are timed at
`ans2_shapes()`: `sx_shapes()` (below), grammar.lsp with refresh_log2 0
(a table a step), kennedy.xls at limit_log2 9 (a rescale every window)
and 63 (none), and 200,000 zero bytes (runs for W's histograms), at the
codec's inc, their inputs made by this tree's W and X (`--only WXY`;
`--only UY` times U and Y alone). A library whose W takes hist and
counts scratch and whose X reads (freqs, cums) (its source says `void*
hist, void* counts`, as 1697712's) is called through those entries
(OLD_W_SIGNATURE, OLD_X_SIGNATURE); W's outputs are compared as (freqs,
cums). W is also timed through a wrapper of each interface, its
allocations in each call (1697712's four tensors; this tree's
`ans2_kernels.model_launch`; 50 calls, each timed apart). Y's state
scratch is given at every K. W's variants: `w_alloc1` (the wrapper's
entries and scratch as one allocation with two views), `w_attr_once` (the
walk's shared-memory attribute set once a process, not once a call),
`norm_rank` (the normalize as 1697712's rank loops, a CTA of 256 a
window, W_RANK_NORM), `w_nopdl` (the three launches without programmatic
dependent launch), `w_fold` (the walk folded into the histogram launch:
one CTA histograms the whole input into shared memory, then walks;
refused past 200 windows; W_FOLD_KERNEL); the diagnostics, whose outputs
differ by design (the script then exits 1): `wdiag_nowalk` (the counts
all ones, the walk skipped), `wdiag_norm1` (the normalize replaced by a
copy of the counts' low bits), `wdiag_walkonly` (the walk alone, the
other launches skipped), `wdiag_walknostage`, `wdiag_walknostore` and
`wdiag_walkbare` (the walk alone without its bulk copies and waits,
without its counts stores, or both), and for a base as 1697712
`wdiag_nowalk@base`,
`wdiag_norm1@base` (there the memset stays). `--profile W` gives each of
W's launches' device time (the memset, hist, walk and norm). A library
whose U and V take no flag of a step with t = 0 (before the fault P6
repair, as 1697712's) is called without it (OLD_O1_SIGNATURES).

Kernels S and X (`--only SX`) are timed at `sx_shapes()`: kennedy.xls (K
= 256), alice29.txt (64), grammar.lsp (2), the first 2^14-byte superblock
(8), ptt5 (128), 200,000 random bytes (64), kennedy.xls at 2,048 and
65,536 lanes; X also at grammar.lsp with refresh_log2 0. A library whose S
is a thread a lane with a scan and a copy (its source says `void* offsets,
void* bits, void* payload`) is called through that entry
(OLD_S_SIGNATURE). Their variants: `s_quad` (T's quad a lane with the
base's single pass, scan and copy: an edit of the BASE's ase.cu, a tree
whose S is a thread a lane, as 14fafdd's), `s_segq` and
`s_seg4` (this tree's S called with a quarter and four times
`ase_ops.segment_steps`),
`x_cta32` (X in CTAs of 32 lanes); the diagnostics, whose outputs differ
by design (the script then exits 1): `sdiag_nocopy` (S's passes that place
the words, the offsets, the scan and the write, skipped), `xdiag_nodiv` (X's reciprocal
a constant), `xdiag_onetable` (every step of X reading table 0), and the
same names with `@base` for a base as 14fafdd (its S's scan, memset and
copy skipped; its X reading every table from global memory).

U and Y's variants: `u_serial` (a chunk's coder pass after, not beside,
the next chunk's model pass), `u_no_t0scan` (t0's sums kept by atomics at
every K, not scanned in the rescale from 128 lanes on), `y_warp64`,
`y_warp256` (one warp with K / 32 lanes a thread up to 64 or 256 lanes);
the diagnostics, one part of a step taken out, whose
outputs differ by design (the script then exits 1): `udiag_xreg` (the
symbol ahead from a register), `udiag_nocoder` (no coder launch),
`udiag_noupdate`, `udiag_norescale` (its barrier kept), `ydiag_wordreg`
(the refill word from a register), `ydiag_nonorm` (the first window's
table kept for every step), `ydiag_nohist` (no histogram; the parent's
`ydiag_nobarrier`, the scan's barrier taken out, has no counterpart here:
with the ring its race can leave a refill waiting on a chunk never
issued). With `--only`
among S-Y, the base and this tree build those kernels' sources alone.
The parent's diagnostics of the same names (its U one kernel, its Y
reading each word from global memory; PERF.md, section 7) were edits of
its sources, dropped once read.

Prints one JSON object: per kernel and shape, each library's ms.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import numpy as np
import torch

import cpprcoder_tpu_torch as ctt
from cpprcoder_tpu_torch.config import adaptive_params_for, pick_lanes
from cpprcoder_tpu_torch.models.cxmodel import rcq_params, rcx_params
from cpprcoder_tpu_torch.models.static_table import normalize_freqs
from cpprcoder_tpu_torch.native import build
from cpprcoder_tpu_torch.ops import (
    ans2_kernels,
    ans2_ops,
    ase_kernels,
    ase_ops,
    expand,
    huffman_kernels,
    huffman_ops,
    layout,
    lz_kernels,
    lz_ops,
    mtf_kernels,
    mtf_ops,
    o1_kernels,
    o1_ops,
    range_kernels,
    range_ops,
    rans_kernels,
    rans_ops,
    rcq_kernels,
    rcx_kernels,
)
from cpprcoder_tpu_torch.reference import ans2_ref, o1_ref

ROOT = Path(__file__).resolve().parent
OUT_ROOT = ROOT / "build" / "compare"
# the corpus in name order (concatenated, chip_smoke.py's 2,810,784 bytes)
CANTERBURY = ("alice29.txt", "asyoulik.txt", "cp.html", "fields.c", "grammar.lsp",
              "kennedy.xls", "lcet10.txt", "plrabn12.txt", "ptt5", "sum", "xargs.1")

# kernel G's step: its two table reads, and its ring read, copy and chain;
# the refill as a branchy load; the table fill by runs, and by a search
G_READS = ("const uint32_t f = u16_at(smem, off);\n"
           "        const uint32_t b = u16_at(reinterpret_cast<const uint8_t*>(btab), off);")
G_RING_STEP = """        const uint32_t nextw = *reinterpret_cast<const uint32_t*>(ring0 + roff);
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
        roff = need ? (roff + SLOT) & RING_MASK : roff;"""
G_BRANCH_STEP = """        const uint32_t x = f * (st >> ANS_PROB_BITS) + b;
        const bool need = x < ANS_LOW;
        uint32_t w = 0;
        if (need) {
          w = widx < l2 ? (uint32_t)col[(size_t)widx * K] : 0u;
          ++widx;
        }
        st = need ? (x << 16) | w : x;
        off = (st << 1) & OFF_MASK;"""
G_BY_RUNS = """  for (int s = threadIdx.x >> 5; s < 256; s += THREADS / 32) {
    const uint32_t c = cs[s], f = fs[s];
    const uint32_t end = c < ANS_TOTAL ? min(c + f, ANS_TOTAL) : 0u;
    for (uint32_t slot = c + lid; slot < end; slot += 32) {
      ftab[slot] = (uint16_t)f;
      btab[slot] = (uint16_t)(slot - c);
      s8[slot] = (uint8_t)s;
    }
  }"""
G_SEARCH = """  (void)lid;
  if (threadIdx.x == 0) cs[256] = cs[255] + fs[255];
  __syncthreads();
  for (uint32_t slot = threadIdx.x; slot < ANS_TOTAL; slot += THREADS) {
    int lo = 0, hi = 256;  // invariant: cs[lo] <= slot < cs[hi]
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int mid = (lo + hi) >> 1;
      if (cs[mid] <= slot)
        lo = mid;
      else
        hi = mid;
    }
    ftab[slot] = (uint16_t)fs[lo];
    btab[slot] = (uint16_t)(slot - cs[lo]);
    s8[slot] = (uint8_t)lo;
  }"""

# kernel M under MTF-1: the head machine's walk over the segments made
# serial (one thread runs every byte of the block: no pairs found, no
# continuations, no jumps over pair-free stretches, no tails)
M_PAIRS = "    if (MTF1 && len > 0) {\n      // the segment's first pair"
M_PAIR = "const int s0 = seg * j, e = min(s0 + seg, valid), p = w.pairs[j];"
M_JUMP = "        if (end - i > 2) {"
M_TAIL = "if ((p >= 0 ? p : e) - s0 > 3 &&"

# kernel L: the words a CT-RC2 lane loads early; the table build after a
# step's barrier
L_AH = "constexpr int AH = MAXT <= SMALL_THREADS ? 0 : LPT == 1 ? 2 : LPT == 2 ? 1 : 0;"
L_BUILD = """    uint32_t sum[8] = {}, a = 0;
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
"""

# name -> (source file, [(text, replacement), ...]): one part of a design
# taken out, or a parameter changed
# s_quad's kernel: the base's S with T's quad (4 threads a lane), inserted
# after quad_update
S_QUAD_KERNEL = """__global__ void __launch_bounds__(DEC_THREADS)
    ase_quad_encode_kernel(const uint8_t* __restrict__ x, const int32_t* __restrict__ lane_len,
                           uint16_t* __restrict__ scratch, int32_t* __restrict__ counts,
                           uint32_t* __restrict__ bits_out, int K, int stride) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = g / QUAD, q = g % QUAD;
  const bool real = lane < K;
  const int len = real ? min(max(lane_len[lane], 0), stride) : 0;
  const int steps = __reduce_max_sync(FULL, len);
  uint32_t tab[QWORDS];
#pragma unroll
  for (int w = 0; w < QWORDS; ++w) tab[w] = 0;
  int size = 0, bits = 0;
  uint32_t acc = 0, nb = 0, total = 0;
  size_t m = 0;
  uint32_t nxt = len > 0 ? x[lane] : 0u;
  for (int t = 0; t < steps; ++t) {
    const bool act = t < len;
    const uint32_t sym = nxt;
    nxt = t + 1 < len ? x[(size_t)(t + 1) * K + lane] : 0u;
    const uint32_t s4 = sym * 0x01010101u;
    int idx = TABLE;
#pragma unroll
    for (int w = 0; w < QWORDS; ++w) {
      const int gw = QWORDS * q + w;
      const uint32_t d = tab[w] ^ s4;
      const uint32_t z = (d - 0x01010101u) & ~d & 0x80808080u & low_bytes(clamp4(size - 4 * gw));
      if (idx == TABLE && z) idx = 4 * gw + ((__ffs(z) - 1) >> 3);
    }
    idx = min(idx, __shfl_xor_sync(FULL, idx, 1, QUAD));
    idx = min(idx, __shfl_xor_sync(FULL, idx, 2, QUAD));
    const bool hit = idx < TABLE;
    const uint32_t val = hit ? ((uint32_t)(size - 1 - idx) << 1) | 1u : sym << 1;
    const uint32_t width = hit ? (uint32_t)bits + 1u : 9u;
    uint32_t nt[QWORDS];
#pragma unroll
    for (int w = 0; w < QWORDS; ++w) nt[w] = tab[w];
    int nsize = size;
    quad_update(nt, q, nsize, sym, hit, hit ? idx : 0);
    if (act) {
      if (!hit && size < TABLE) bits = 32 - __clz(size);
#pragma unroll
      for (int w = 0; w < QWORDS; ++w) tab[w] = nt[w];
      size = nsize;
      acc |= val << nb;
      nb += width;
      total += width;
      if (nb >= 16) {
        if (q == 0) scratch[m * K + lane] = (uint16_t)acc;
        ++m;
        acc >>= 16;
        nb -= 16;
      }
    }
  }
  if (!real || q != 0) return;
  if (nb > 0) {
    scratch[m * K + lane] = (uint16_t)acc;
    ++m;
  }
  counts[lane] = (int32_t)m;
  bits_out[lane] = total;
}
"""

# kernel W's normalize as 1697712 had it (ans2_model.cuh `normalize`: a
# CTA of 256 threads a window, a thread a symbol, ranks counted by 256
# shared reads a thread), for the norm_rank variant: injected before this
# tree's norm kernel, which it replaces (the warp version renamed, unused)
W_RANK_NORM = r"""
struct RankScratch {
  unsigned long long red[MAX_WARPS];
  uint32_t part[MAX_WARPS];
  uint32_t key[256];
  uint32_t ex[256];
  int full;
};

__device__ __forceinline__ unsigned long long rank_block_sum(unsigned long long v,
                                                             RankScratch& sc) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) sc.red[warp] = v;
  __syncthreads();
  unsigned long long s = 0;
  for (int i = 0; i < warps; ++i) s += sc.red[i];
  __syncthreads();
  return s;
}

__device__ __forceinline__ uint32_t rank_exclusive_scan(uint32_t v, RankScratch& sc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) sc.part[warp] = incl;
  __syncthreads();
  uint32_t base = 0;
  for (int i = 0; i < warp; ++i) base += sc.part[i];
  __syncthreads();
  return base + incl - v;
}

__device__ inline uint32_t rank_normalize(unsigned long long cnt, RankScratch& sc,
                                          uint32_t& c_out) {
  const int tid = threadIdx.x;
  const unsigned long long n = rank_block_sum(cnt, sc);
  if (n == 0) {
    c_out = 0;
    return 0;
  }
  const int bitlen = 64 - __clzll((long long)(n - 1));
  const int shift = bitlen > (int)PROB_BITS ? bitlen - (int)PROB_BITS : 0;
  const bool present = cnt > 0;
  uint32_t c = (uint32_t)(cnt >> shift);
  if (present && c == 0) c = 1;
  const uint32_t np = (uint32_t)rank_block_sum(c, sc);
  const uint32_t scaled = c << PROB_BITS;
  uint32_t f = scaled / np;
  const uint32_t r = scaled - f * np;
  if (present && f == 0) f = 1;
  const int d = (int)TOTAL - (int)rank_block_sum(f, sc);
  if (d > 0) {
    const uint32_t key = present ? r + 1 : 0;
    sc.key[tid] = key;
    __syncthreads();
    if (present) {
      int rank = 0;
      for (int s = 0; s < 256; ++s) {
        const uint32_t o = sc.key[s];
        rank += (o > key) | ((o == key) & (s < tid));
      }
      f += rank < d;
    }
    __syncthreads();
  } else if (d < 0) {
    sc.key[tid] = f;
    sc.ex[tid] = present ? f - 1 : 0;
    __syncthreads();
    if (present) {
      int before = 0;
      for (int s = 0; s < 256; ++s) {
        const uint32_t o = sc.key[s];
        if (o > f || (o == f && s < tid)) before += (int)sc.ex[s];
      }
      const int take = min(max(-d - before, 0), (int)f - 1);
      f -= (uint32_t)take;
    }
    __syncthreads();
  }
  if (tid == 0) sc.full = -1;
  __syncthreads();
  if (f == TOTAL) sc.full = tid;
  __syncthreads();
  const int full = sc.full;
  if (full >= 0) {
    if (tid == full) f -= 1;
    if (tid == ((full + 1) & 255)) f += 1;
  }
  c_out = rank_exclusive_scan(f, sc);
  return f;
}

__global__ void __launch_bounds__(NORM_CTA)
    ans2_norm_kernel(const unsigned long long* __restrict__ counts, uint2* __restrict__ entries,
                     int B) {
  __shared__ RankScratch sc;
  griddep_wait();
  const size_t at = (size_t)blockIdx.x * 256 + threadIdx.x;
  uint32_t c;
  const uint32_t f = rank_normalize(counts[at], sc, c);
  entries[at] = make_entry(f, c);
}

"""

# edits for W's walk diagnostics: the other launches skipped; the staging
# (bulk copies and waits) skipped; the counts stores skipped
W_WALK_ONLY = [
    ("  ans2_hist_kernel<<<dim3(n_snap, rows), HIST_THREADS, 0, s>>>(",
     "  if (false) ans2_hist_kernel<<<dim3(n_snap, rows), HIST_THREADS, 0, s>>>("),
    ("  if (e == cudaSuccess)\n    e = launch_after(ans2_norm_kernel,",
     "  if (false)\n    e = launch_after(ans2_norm_kernel,")]
W_NO_STAGE = [
    ("    mbar_wait(bar + (c & 1), (uint32_t)(c >> 1) & 1u);\n", ""),
    ("    stage(0);\n    if (n_chunks > 1) stage(1);\n", ""),
    ("      stage(c + 2);\n", "")]
W_NO_STORE = [("      *out = cnt;\n", "      if (cnt == 12345) *out = cnt;\n")]

# kernel W's launch-gap alternative to programmatic dependent launch: the
# walk folded into the histogram launch (one CTA histograms the whole input
# into shared memory, then walks; at most 200 windows, refused past that)
W_FOLD_KERNEL = r"""// The fold (variant w_fold): one CTA takes every window's histogram into
// shared memory (at most 200 windows), then walks them; no hist launch.
__global__ void __launch_bounds__(WALK_THREADS)
    ans2_fold_kernel(const uint8_t* __restrict__ x, unsigned long long* __restrict__ counts,
                     long long n, int K, int steps, int r, int n_snap, uint32_t inc,
                     int limit_log2) {
  extern __shared__ __align__(16) uint32_t hs[];
  const int s = threadIdx.x;
  for (int i = s; i < n_snap * 256; i += WALK_THREADS) hs[i] = 0;
  griddep_wait();
  griddep_launch();
  __syncthreads();
  const int kshift = __ffs(K) - 1;
  for (long long p = s; p < n; p += WALK_THREADS)
    atomicAdd(hs + snapshot_index((uint32_t)(p >> kshift), r) * 256 + x[p], 1u);
  __syncthreads();
  const bool can_rescale = limit_log2 < 64;
  const unsigned long long limit = can_rescale ? 1ull << limit_log2 : 0;
  unsigned long long cnt = 1, total = 256;
  for (int w = 0; w < n_snap; ++w) {
    if (can_rescale && total >= limit) {
      const unsigned long long h = cnt >> 1;
      const int odd = __syncthreads_count((int)(cnt & 1));
      const int even_half = __syncthreads_count((int)(~h & 1));
      cnt = h | 1;
      total = (total - odd) / 2 + even_half;
    }
    counts[(size_t)w * 256 + s] = cnt;
    cnt += (unsigned long long)inc * hs[w * 256 + s];
    unsigned long long e = window_start(w + 1, r);
    if (e > (unsigned long long)steps) e = steps;
    total += (unsigned long long)inc * coded(window_start(w, r), e, n, K);
  }
}

"""

# kernel Z's diagnostics: its window scan (step 3), its sort (step 4) or
# its byte compares (step 5) skipped (the outputs then differ)
Z_NO_SCAN = [("j >= b0; j -= (int)blockDim.x", "j >= t0; j -= (int)blockDim.x")]
Z_NO_SORT = [("      ct::block_sort(it, order);\n", "")]
Z_NO_LCP = [("r < LANE_BYTES / 4 && q < lim", "r < 0 && q < lim"),
            ("more = mm == lim && q < lim;", "more = false;")]
# kernel K's diagnostics: its sort (the tile sort, the crossing groups'
# merges and the merge passes: each group then in the scatter's order), its
# ladder launch or its pick launch skipped (the outputs then differ)
K_NO_SORT = [("    k_sort<PackedTile><<<", "    if (false) k_sort<PackedTile><<<"),
             ("    k_sort<WideTile><<<", "    if (false) k_sort<WideTile><<<"),
             ("  k_fix<<<", "  if (false) k_fix<<<"),
             ("    k_merge<<<", "    if (false) k_merge<<<")]
K_NO_LADDER = [("  k_ladder<<<", "  if (false) k_ladder<<<")]
K_NO_PICK = [("  k_pick<<<", "  if (false) k_pick<<<")]
# kernel K's geometry: tiles of 2,048 keys; the wide keys (K5, 8 a thread)
# at every W, not only past 2^20
K_CAP_2048 = [("constexpr int SORT_THREADS = 512;", "constexpr int SORT_THREADS = 256;")]
K_WIDE = [("  if (w <= (1 << 20)) {\n    if ((e = cudaFuncSetAttribute(k_sort<PackedTile>",
           "  if (false) {\n    if ((e = cudaFuncSetAttribute(k_sort<PackedTile>")]

VARIANTS = {
    # kernel A: every row requantized at every window
    "a_all_rows": ("rc_encode.cuh", [(
        "ct::requant_changed<ROUNDS, true>(C, cum, last, rows, climit, touched);",
        "for (int r = tid >> 5; r < rows; r += bd >> 5) ct::requant_row<ROUNDS>("
        "C + (size_t)r * 256, cum + (size_t)r * ct::CUM_STRIDE, climit);")]),
    # kernel A: the rows that changed found by their totals alone
    "a_no_touched": ("rc_encode.cuh", [(
        "ct::requant_changed<ROUNDS, true>(C, cum, last, rows, climit, touched);",
        "ct::requant_changed<ROUNDS>(C, cum, last, rows, climit);")]),
    # kernel A: a thread a lane, no more (a block sized by lanes alone)
    "a_block_by_lanes": ("rc_encode.cuh", [(
        "const int threads = ct::coder_threads((K + G - 1) / G, held, ONE_ROW);",
        "const int threads = ONE_ROW ? ct::coder_threads(K, 1, true)"
        " : ct::block_threads((K + G - 1) / G);")]),
    # kernel A: one block a stream at every K
    "a_no_cluster": ("rcx_encode.cu", [
        ("G = ct::CLUSTER_CTAS;", "G = 1;"),
        ("if (K < ct::CLUSTER_MIN_K) {", "if (K < 0) {")]),
    # kernel A: each step loads its own symbol
    "a_no_ahead": ("rc_encode.cuh", [(
        "sym = nsym[m] & 0xFFu;\n"
        "            ctx = nsym[m] >> pshift;\n"
        "            nsym[m] = (j + 1 < len[m] ? (uint32_t)xj[K + lane] : 0u) | (sym << 8);",
        "sym = xj[lane];\n"
        "            ctx = nsym[m] >> pshift;\n"
        "            nsym[m] = sym << 8;")]),
    # kernel A: at 8 lanes a thread, lane state unpacked and the look-ahead on
    "a_no_pack": ("rc_encode.cuh", [
        ("constexpr bool PACK = LPT >= 8;", "constexpr bool PACK = ONE_ROW && LPT >= 8;"),
        ("constexpr bool AHEAD = LPT < 8;", "constexpr bool AHEAD = !ONE_ROW || LPT < 8;")]),
    # kernel I: words in flight, table bits, block size
    "i_ahead2": ("huffman_decode.cu", [("constexpr int AHEAD = 8;", "constexpr int AHEAD = 2;")]),
    "i_ahead4": ("huffman_decode.cu", [("constexpr int AHEAD = 8;", "constexpr int AHEAD = 4;")]),
    "i_ahead16": ("huffman_decode.cu", [("constexpr int AHEAD = 8;",
                                         "constexpr int AHEAD = 16;")]),
    "i_lut0": ("huffman_decode.cu", [("constexpr int LUT_BITS = 12;",
                                      "constexpr int LUT_BITS = 0;")]),
    "i_lut10": ("huffman_decode.cu", [("constexpr int LUT_BITS = 12;",
                                       "constexpr int LUT_BITS = 10;")]),
    "i_lut11": ("huffman_decode.cu", [("constexpr int LUT_BITS = 12;",
                                       "constexpr int LUT_BITS = 11;")]),
    "i_threads128": ("huffman_decode.cu", [("constexpr int THREADS = 64;",
                                            "constexpr int THREADS = 128;")]),
    "i_threads32": ("huffman_decode.cu", [("constexpr int THREADS = 64;",
                                           "constexpr int THREADS = 32;")]),
    # kernel G: the step's reads: three dependent ones (s, then f and cum by
    # s), or one u32 entry f | (slot - cum) << 15 in place of the two u16
    # tables
    "g_three_reads": ("rans_decode.cu", [
        (G_READS, "const uint32_t f = fs[s], b = (off >> 1) - cs[s];")]),
    "g_packed": ("rans_decode.cu", [
        ("      ftab[slot] = (uint16_t)f;\n      btab[slot] = (uint16_t)(slot - c);",
         "      reinterpret_cast<uint32_t*>(smem)[slot] = f | (slot - c) << 15;"),
        (G_READS, "const uint32_t e = reinterpret_cast<const uint32_t*>(smem)[off >> 1];\n"
                  "        const uint32_t f = e & 0x7FFFu, b = e >> 15;")]),
    # kernel G: no words through the ring (the word loaded in the refill, in
    # a branch; the ring's copies before the loop stay)
    "g_no_prefetch": ("rans_decode.cu", [(G_RING_STEP, G_BRANCH_STEP)]),
    # kernel G: a ring of 16 or 32 words a lane (4 or 8 steps a block, one
    # block's copies in flight)
    "g_ring16": ("rans_decode.cu", [("constexpr int RING = 64;", "constexpr int RING = 16;")]),
    "g_ring32": ("rans_decode.cu", [("constexpr int RING = 64;", "constexpr int RING = 32;")]),
    # kernel G: the tables built by a search a slot
    "g_search": ("rans_decode.cu", [
        ("__shared__ uint32_t fs[256], cs[256];", "__shared__ uint32_t fs[256], cs[257];"),
        (G_BY_RUNS, G_SEARCH)]),
    "g_threads32": ("rans_decode.cu", [("constexpr int THREADS = 128;",
                                        "constexpr int THREADS = 32;")]),
    "g_threads64": ("rans_decode.cu", [("constexpr int THREADS = 128;",
                                        "constexpr int THREADS = 64;")]),
    # kernel B: every run written by its own thread (no warp's long-run path)
    "b_no_long_run": ("expand.cu", [("constexpr uint32_t LONG_RUN = 32;",
                                     "constexpr uint32_t LONG_RUN = EV_RUN_MASK;")]),
    # kernel B: 8 or 32 lanes a block
    "b_lanes8": ("expand.cu", [("constexpr int LANES = 16;", "constexpr int LANES = 8;")]),
    "b_lanes32": ("expand.cu", [("constexpr int LANES = 16;", "constexpr int LANES = 32;")]),
    # kernel H: 8, 32 or 64 steps a chunk; 8 or 16 KB tiles; the words a
    # chunk owns whole by plain stores; the payload zeroed by a memset
    # launch, not by the lengths pass
    "h_chunk8": ("huffman_encode.cu", [("constexpr int CHUNK = 16;", "constexpr int CHUNK = 8;")]),
    "h_chunk32": ("huffman_encode.cu", [("constexpr int CHUNK = 16;",
                                         "constexpr int CHUNK = 32;")]),
    "h_chunk64": ("huffman_encode.cu", [("constexpr int CHUNK = 16;",
                                         "constexpr int CHUNK = 64;")]),
    "h_tile8k": ("huffman_encode.cu", [("constexpr int TILE = 4096;",
                                        "constexpr int TILE = 8192;")]),
    "h_tile16k": ("huffman_encode.cu", [("constexpr int TILE = 4096;",
                                         "constexpr int TILE = 16384;")]),
    "h_stores": ("huffman_encode.cu", [(
        "      if (nb >= 32) {\n        atomicOr(w, (uint32_t)acc);\n",
        "      if (nb >= 32) {\n        if (lo)\n          atomicOr(w, (uint32_t)acc);\n"
        "        else\n          *w = (uint32_t)acc;\n")]),
    "h_memset": ("huffman_encode.cu", [
        ("  for (size_t q = block * THREADS + threadIdx.x; q < nzero / 4; q += nthreads)\n"
         "    reinterpret_cast<uint4*>(zero)[q] = make_uint4(0, 0, 0, 0);\n"
         "  if (block == 0 && threadIdx.x < (nzero & 3)) "
         "zero[(nzero & ~(size_t)3) + threadIdx.x] = 0;\n", "  (void)block, (void)nthreads;\n"),
        ("  const Geo g = {K, stride, kb, tsteps, nch};",
         "  cudaMemsetAsync(pw, 0, ((size_t)payload_words + 1) * 4, st);\n"
         "  const Geo g = {K, stride, kb, tsteps, nch};")]),
    "m_serial_machine": ("mtf.cu", [
        (M_PAIRS, M_PAIRS.replace("MTF1 && len > 0", "false")),
        (M_PAIR, M_PAIR.replace("w.pairs[j]", "-1")),
        (M_JUMP, M_JUMP.replace("end - i > 2", "false")),
        (M_TAIL, "if (false &&")]),
    # kernels M and N: 16 warps a CTA (64 segments a block, 512 threads);
    # one CTA a block, or a cluster of two
    "mn_warps16": ("mtf.cu", [("constexpr int WARPS = 32;", "constexpr int WARPS = 16;")]),
    "mn_cluster1": ("mtf.cu", [("constexpr int CLUSTER = 4;", "constexpr int CLUSTER = 1;")]),
    "mn_cluster2": ("mtf.cu", [("constexpr int CLUSTER = 4;", "constexpr int CLUSTER = 2;")]),
    # kernels M and N: a cluster of 8 CTAs of 16 warps (128 segments a block)
    "mn_cluster8_warps16": ("mtf.cu", [("constexpr int CLUSTER = 4;", "constexpr int CLUSTER = 8;"),
                                       ("constexpr int WARPS = 32;", "constexpr int WARPS = 16;")]),
    # kernel J: CT-RC2 CTAs of 256 lanes at every K (not 64 up to 1,024);
    # a histogram warp for each 256 lanes, not 64 (8 bytes of a row a
    # lane); symbols in groups of 8 steps in CTAs of 64 lanes too, not 16
    "j_coders256": ("rc_exact.cu", [("constexpr int ENC_ADAPTIVE_SMALL = 64;",
                                     "constexpr int ENC_ADAPTIVE_SMALL = 256;")]),
    "j_hist_fewer": ("rc_exact.cu", [(
        "const int H = K <= 64 ? 1 : K <= 128 ? 2 : K <= 256 ? 4 : MAX_HIST_WARPS;",
        "const int H = K <= 256 ? 1 : K <= 512 ? 2 : K <= 1024 ? 4 : MAX_HIST_WARPS;")]),
    "j_group8": ("rc_exact.cu", [("constexpr int AHEAD_SMALL = 16;", "constexpr int AHEAD_SMALL = 8;")]),
    # kernel L: CT-RC2's search by 8 halvings at every lane count; no word
    # loaded early in any CTA, or words loaded early in small CTAs too; one
    # CTA up to 8,192 lanes (a cluster of 2 there by default)
    "l_search8": ("rc_exact.cu", [("constexpr int PIVOT_THREADS = 128;",
                                   "constexpr int PIVOT_THREADS = 0;")]),
    "l_words0": ("rc_exact.cu", [(L_AH, "constexpr int AH = 0;")]),
    "l_words_early": ("rc_exact.cu", [(L_AH, "constexpr int AH = LPT == 1 ? 2 : LPT == 2 ? 1 : 0;")]),
    "l_cta8192": ("rc_exact.cu", [("constexpr int DEC_CTA_LANES = 4096;",
                                   "constexpr int DEC_CTA_LANES = 8192;")]),
    # kernel L, diagnostics: one part of a CT-RC2 step taken out (the table
    # build after the barrier, the barrier, the symbol's atomic, the
    # search), so their outputs differ and are reported so; their times
    # say what each part costs in place
    "ldiag_nobuild": ("rc_exact.cu", [(L_BUILD, "")]),
    "ldiag_nosync": ("rc_exact.cu", [("    if (G > 1)\n      cg::this_cluster().sync();\n"
                                      "    else\n      __syncthreads();\n", "")]),
    "ldiag_noatomic": ("rc_exact.cu", [("      if (on) atomicAdd(&h[s], 1u);\n", "")]),
    "ldiag_nosearch": ("rc_exact.cu", [
        ("        if (PIVOTS) {\n          uint32_t cnt = 0;",
         "        if (false) {\n          uint32_t cnt = 0;"),
        ("          for (uint32_t b = 128; b; b >>= 1)\n            if (t * row[s + b] <= cd) s += b;",
         "          s = cd & 0xFFu;")]),
    # kernel V's second design, diagnostics (outputs differ): no rescale
    # (its barrier kept), no update, the word loaded ahead from a register
    "vdiag2_norescale": ("o1_decode.cu", [(
        "    rescale<WIDE>(m, limit1, limit0);\n", "    __syncthreads();\n")]),
    "vdiag2_noatomic": ("o1_decode.cu", [(
        "      update_step<WIDE, MULTI>(m, active, r, sym, inc);\n", "")]),
    "vdiag2_norefill": ("o1_decode.cu", [(
        "nw = widx < (uint32_t)l4 ? words[(size_t)widx * K + lane] : 0u;",
        "nw = widx * 0x9E3779B9u + lane;")]),
    # kernel U's second design: a chunk's coder pass after the next chunk's
    # model pass on one stream (not beside it); t0's sums kept by atomics
    # at every K (not scanned in the rescale from 128 lanes on)
    "u_serial": ("o1_encode.cu", [("  if (chunk >= L) {", "  if (true) {")]),
    "u_no_t0scan": ("o1_encode.cu", [("constexpr int T0SCAN_LANES = 128;",
                                      "constexpr int T0SCAN_LANES = 1 << 30;")]),
    # kernel U, diagnostics (outputs differ): the symbol ahead from a
    # register (no read of x), no coder pass, no update, no rescale (its
    # barrier kept)
    "udiag_xreg": ("o1_encode.cu", [(
        "const uint32_t sn = next ? x[(size_t)(j + 1) * K + lane] : 0u;",
        "const uint32_t sn = next ? (uint32_t)((j + 1) * 0x9E3779B9u + lane) >> 24 : 0u;")]),
    "udiag_nocoder": ("o1_encode.cu", [(
        "  o1_coder_kernel<<<", "  if (false) o1_coder_kernel<<<")]),
    "udiag_noupdate": ("o1_encode.cu", [(
        "      update_step<WIDE, false, T0SCAN>(m, act, ctx, s, inc);\n", "")]),
    "udiag_norescale": ("o1_encode.cu", [(
        "      rescale<WIDE, T0SCAN>(m, limit1, limit0);\n", "      __syncthreads();\n")]),
    # kernel Y's second design: one warp with K / 32 lanes a thread up to
    # 64 or 256 lanes (a thread a lane there by default); the diagnostics
    # (outputs differ): the refill word from a register, the first window's
    # table kept for every step, no histogram (a step's adds to its warp's
    # copy). Not the scan's barrier taken out: with the ring, its race can
    # leave a refill waiting on a chunk never issued
    "y_warp64": ("ans2_decode.cu", [("constexpr int WARP_LANES = 32;",
                                     "constexpr int WARP_LANES = 64;")]),
    "y_warp256": ("ans2_decode.cu", [("constexpr int WARP_LANES = 32;",
                                      "constexpr int WARP_LANES = 256;")]),
    "ydiag_wordreg": ("ans2_decode.cu", [(
        "rg.word(at++)", "((uint32_t)(at++ * 0x9E3779B9ull) >> 16)")]),
    "ydiag_nonorm": ("ans2_decode.cu", [
        ("const unsigned long long t1w = window_start(w + 1, r);",
         "const unsigned long long t1w = steps;"),
        ("if (t0 >= (unsigned long long)steps) break;",
         "if (t0 >= (unsigned long long)steps || w > 0) break;")]),
    "ydiag_nohist": ("ans2_decode.cu", [(
        "            atomicAdd(whist + s, 1u);\n", "")]),
    # kernel S, diagnostics (outputs differ): the passes that place the
    # words (the offsets, the scan and the write) skipped
    "sdiag_nocopy": ("ase.cu", [
        ("  ase_scan_kernel<<<1, SCAN_THREADS, 0, st>>>",
         "  if (false) ase_scan_kernel<<<1, SCAN_THREADS, 0, st>>>"),
        ("  ase_lane_kernel<<<", "  if (false) ase_lane_kernel<<<"),
        ("  ase_code_kernel<true><<<", "  if (false) ase_code_kernel<true><<<")]),
    # kernel S on T's quad (4 threads a lane, 16 entries each), with the
    # base's single pass, scan and copy: an edit of the base's ase.cu (a
    # tree whose S is a thread a lane, as 14fafdd's)
    "s_quad": ("ase.cu", [
        ("// Word i of the payload, 0 outside [0, end).", S_QUAD_KERNEL
         + "\n// Word i of the payload, 0 outside [0, end)."),
        ("  const int threads = K < THREADS ? K : THREADS;\n"
         "  ase_encode_kernel<<<(K + threads - 1) / threads, threads, 0, st>>>(",
         "  ase_quad_encode_kernel<<<(QUAD * K + DEC_THREADS - 1) / DEC_THREADS, "
         "DEC_THREADS, 0, st>>>(")]),
    # kernel W's second design: the normalize as the rank loops of 1697712
    # (a CTA of 256 a window); the three launches without programmatic
    # dependent launch; the diagnostics (outputs differ): the counts all
    # ones with the walk skipped, the normalize replaced by a copy of the
    # counts' low bits
    "norm_rank": ("ans2_encode.cu", [
        ("constexpr int NORM_WINDOWS = 4;      // windows a norm CTA, a warp each\n"
         "constexpr int NORM_CTA = 32 * NORM_WINDOWS;",
         "constexpr int NORM_WINDOWS = 1;\nconstexpr int NORM_CTA = 256;"),
        ("__global__ void __launch_bounds__(NORM_CTA)\n    ans2_norm_kernel(",
         W_RANK_NORM + "__global__ void __launch_bounds__(NORM_CTA)\n"
         "    ans2_norm_kernel_warp(")]),
    # W's wrapper with its scratch and entries as one allocation and two
    # views (this tree's library; its wrapper case alone differs), and W
    # with the walk's shared-memory attribute set once a process, not once
    # a call
    "w_alloc1": ("ans2_encode.cu", []),
    "w_attr_once": ("ans2_encode.cu", [(
        "  e = cudaFuncSetAttribute(walk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);",
        "  static const void* set_for[4] = {};\n"
        "  const int wi = rows == 1 ? 0 : rows == 2 ? 1 : rows == 4 ? 2 : 3;\n"
        "  e = cudaSuccess;\n"
        "  if (set_for[wi] == nullptr) {\n"
        "    e = cudaFuncSetAttribute(walk, cudaFuncAttributeMaxDynamicSharedMemorySize,\n"
        "                             2 * WALK_CHUNK);\n"
        "    if (e == cudaSuccess) set_for[wi] = (const void*)walk;\n"
        "  }")]),
    "w_nopdl": ("ans2_encode.cu", [("programmaticStreamSerializationAllowed = 1;",
                                    "programmaticStreamSerializationAllowed = 0;")]),
    "w_fold": ("ans2_encode.cu", [
        ("// A kernel after the last on the stream, by programmatic dependent launch.",
         W_FOLD_KERNEL + "// A kernel after the last on the stream, by programmatic dependent launch."),
        ("""  ans2_hist_kernel<<<dim3(n_snap, rows), HIST_THREADS, 0, s>>>((const uint8_t*)x, part, n, K,
                                                               steps, r, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int per = WALK_CHUNK / (1024 * rows) > 0 ? WALK_CHUNK / (1024 * rows) : 1;
  const int smem = 2 * per * rows * 1024;
  const auto walk = rows == 1   ? ans2_walk_kernel<1>
                    : rows == 2 ? ans2_walk_kernel<2>
                    : rows == 4 ? ans2_walk_kernel<4>
                                : ans2_walk_kernel<0>;
  e = cudaFuncSetAttribute(walk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = launch_after(walk, dim3(1), dim3(WALK_THREADS), smem, s, (const uint32_t*)part, counts, n,
                     K, steps, r, n_snap, rows, (uint32_t)inc, limit_log2);""",
         """  (void)part;
  if (n_snap > 200) return (int)cudaErrorInvalidValue;
  const int smem = n_snap * 1024;
  cudaError_t e = cudaFuncSetAttribute(ans2_fold_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = launch_after(ans2_fold_kernel, dim3(1), dim3(WALK_THREADS), smem, s, (const uint8_t*)x,
                     counts, n, K, steps, r, n_snap, (uint32_t)inc, limit_log2);""")]),
    "wdiag_nowalk": ("ans2_encode.cu", [
        ("  if (e == cudaSuccess)\n    e = launch_after(walk,",
         "  if (false)\n    e = launch_after(walk,"),
        ("  warp_normalize(c8, f, c);\n  uint4* eo",
         "  for (int i = 0; i < PER_LANE; ++i) c8[i] = 1;\n  warp_normalize(c8, f, c);\n"
         "  uint4* eo")]),
    # the walk alone (hist and norm launches skipped), and further without
    # its bulk copies and their waits, without its counts stores, or both
    "wdiag_walkonly": ("ans2_encode.cu", W_WALK_ONLY),
    "wdiag_walknostage": ("ans2_encode.cu", W_WALK_ONLY + W_NO_STAGE),
    "wdiag_walknostore": ("ans2_encode.cu", W_WALK_ONLY + W_NO_STORE),
    "wdiag_walkbare": ("ans2_encode.cu", W_WALK_ONLY + W_NO_STAGE + W_NO_STORE),
    "wdiag_norm1": ("ans2_encode.cu", [
        ("  warp_normalize(c8, f, c);\n  uint4* eo",
         "  for (int i = 0; i < PER_LANE; ++i) f[i] = c[i] = (uint32_t)c8[i];\n  uint4* eo")]),
    # kernel X: CTAs of 32 lanes; the diagnostics (outputs differ): the
    # reciprocal a constant, every step reading table 0
    "s_segq": ("ase.cu", []),
    "s_seg4": ("ase.cu", []),
    "x_cta32": ("ans2_encode.cu", [("constexpr int THREADS = 128;  // X: lanes a CTA",
                                    "constexpr int THREADS = 32;  // X: lanes a CTA")]),
    "xdiag_nodiv": ("ans2_encode.cu", [("f ? 0xFFFFFFFFu / f : 0u", "f ? 0x40000u : 0u")]),
    "xdiag_onetable": ("ans2_encode.cu", [
        ("entry(entries, snapshot_index(", "entry(entries, 0u * snapshot_index("),
        ("const size_t row = (size_t)w * 256 + threadIdx.x;",
         "const size_t row = threadIdx.x;")]),
    # kernel T's second design: CTAs of 64 or 128 threads (16 or 32 lanes)
    # in place of one warp; the diagnostics: no entry shuffle (the symbol
    # its index), no update
    "t_cta64": ("ase.cu", [("constexpr int DEC_THREADS = 32;",
                            "constexpr int DEC_THREADS = 64;")]),
    "t_cta128": ("ase.cu", [("constexpr int DEC_THREADS = 32;",
                             "constexpr int DEC_THREADS = 128;")]),
    "tdiag2_noentry": ("ase.cu", [("const uint32_t e = quad_entry(tab, idx);",
                                   "const uint32_t e = (uint32_t)idx ^ tab[0];")]),
    "tdiag2_noupdate": ("ase.cu", [(
        "    quad_update(tab, q, size, sym, hit, idx);\n",
        "    tab[0] ^= sym;\n    if (!hit && size < TABLE) ++size;\n")]),
    # kernels U and V: the rescale's rows, in place of warp w checking rows
    # w, w + nw, ...: a run of R = 256 / nw rows a warp, or lane l of warp w
    # row l + R * ((w + l) % nw) (spread, a warp's reads in R banks)
    "o1_rows_contiguous": ("o1_model.cuh", [
        ("m.rowtot[w + nw * ln]", "m.rowtot[w * (256 / nw) + ln]"),
        ("halve_row<WIDE>(m, w + nw * i);", "halve_row<WIDE>(m, w * (256 / nw) + i);")]),
    "zdiag_noscan": ("lz_match.cu", Z_NO_SCAN),
    "zdiag_nosort": ("lz_match.cu", Z_NO_SORT),
    "zdiag_nolcp": ("lz_match.cu", Z_NO_LCP),
    "kdiag_nosort": ("lz_match_v2.cu", K_NO_SORT),
    "kdiag_noladder": ("lz_match_v2.cu", K_NO_LADDER),
    "kdiag_nopick": ("lz_match_v2.cu", K_NO_PICK),
    "k_cap2048": ("lz_match_v2.cu", K_CAP_2048),
    "k_wide": ("lz_match_v2.cu", K_WIDE),
    "o1_rows_rotated": ("o1_model.cuh", [
        ("m.rowtot[w + nw * ln]", "m.rowtot[ln + 256 / nw * ((w + ln) & (nw - 1))]"),
        ("halve_row<WIDE>(m, w + nw * i);",
         "halve_row<WIDE>(m, i + 256 / nw * ((w + i) & (nw - 1)));")]),
}


# the entry point of each kernel, and the source a variant library builds
ENTRY = {"A": "ct_rcx_encode", "B": "ct_expand_count", "C": "ct_rcx_decode",
         "D": "ct_rcq_encode", "E": "ct_rcq_decode", "F": "ct_rans_encode",
         "G": "ct_rans_decode", "H": "ct_huffman_encode_stream", "I": "ct_huffman_decode",
         "J": "ct_rc_exact_encode", "L": "ct_rc_exact_decode",
         "M": "ct_mtf_encode", "N": "ct_mtf_decode",
         "P": "ct_lz_walk",
         # Q: the two-launch entry, or the three-launch one of an older tree
         "Q": ("ct_lz_serialize", "ct_lz_clamp"), "R": "ct_lz_decode",
         "S": "ct_ase_encode", "T": "ct_ase_decode", "U": "ct_o1_encode",
         "V": "ct_o1_decode", "W": "ct_ans2_model", "X": "ct_ans2_encode",
         "Y": "ct_ans2_decode", "Z": "ct_lz_match_v1", "K": "ct_lz_match_v2"}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the CT-LZ4 entry points of a tree whose Q is three launches with a cumsum
# and host reads between them (ct_lz_clamp, ct_lz_sizes, ct_lz_write) and
# whose R is one launch (comp, bases, sizes, out, err, n_segs, n, s, stream)
OLD_LZ_SIGNATURES = {
    "ct_lz_clamp": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "ct_lz_sizes": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "ct_lz_write": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "ct_lz_decode": [_P, _P, _P, _P, _P, _I, _L, _L, _P],
}
# kernel P of a tree whose walk takes step and off (int32 [n, w], built by
# lz_ops.walk_inputs) and an int32 exits scratch, one launch: step, off,
# exits, mpos, mlen, moff, count, n, w, tcap, stream
OLD_WALK_SIGNATURE = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]
# kernel S of a tree whose S is a thread a lane with a scan and a copy:
# x, lane_len, scratch, counts, offsets, bits, payload, K, stride, cap,
# stream
OLD_S_SIGNATURE = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]
# kernels W and X of a tree whose W takes hist and counts scratch and
# whose X reads (freqs, cums), as 1697712's: x, hist, counts, freq, cum,
# n, K, steps, inc, limit_log2, r, n_snap, stream; x, lane_len, freq, cum,
# ev, states, K, stride, r, stream
OLD_W_SIGNATURE = [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P]
OLD_X_SIGNATURE = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]
# kernels U and V of a tree without the flag of a step with t = 0 (as
# 1697712's)
OLD_O1_SIGNATURES = {
    "ct_o1_encode": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "ct_o1_coder": [_P, _P, _P, _I, _I, _I, _I, _P],
    "ct_o1_decode": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}
# kernel S's segment length in the s_seg* variants: this tree's library,
# called with ase_ops.segment_steps times the scale
SEG_SCALE = {"s_segq": 0.25, "s_seg4": 4.0}
# U's chunks in the case that times its chunk edges
U_SMALL_CHUNK = 256
# the source of each of kernels K and S-Z
SOURCE_OF = {"S": "ase.cu", "T": "ase.cu", "U": "o1_encode.cu", "V": "o1_decode.cu",
             "W": "ans2_encode.cu", "X": "ans2_encode.cu", "Y": "ans2_decode.cu",
             "Z": "lz_match.cu", "K": "lz_match_v2.cu"}
VARIANT_SOURCE = {"a": "rcx_encode.cu", "b": "expand.cu", "g": "rans_decode.cu",
                  "h": "huffman_encode.cu", "i": "huffman_decode.cu", "j": "rc_exact.cu",
                  "l": "rc_exact.cu", "ldiag": "rc_exact.cu", "m": "mtf.cu", "mn": "mtf.cu",
                  "vdiag2": "o1_decode.cu", "t": "ase.cu", "tdiag2": "ase.cu",
                  "o1": ("o1_encode.cu", "o1_decode.cu"), "u": "o1_encode.cu",
                  "udiag": "o1_encode.cu", "y": "ans2_decode.cu", "ydiag": "ans2_decode.cu",
                  "s": "ase.cu", "sdiag": "ase.cu", "x": "ans2_encode.cu",
                  "xdiag": "ans2_encode.cu", "w": "ans2_encode.cu",
                  "wdiag": "ans2_encode.cu", "norm": "ans2_encode.cu",
                  "zdiag": "lz_match.cu", "kdiag": "lz_match_v2.cu", "k": "lz_match_v2.cu"}
# variants that edit the base's sources, not this tree's: s_quad, and
# NAME@base, the diagnostics of a base whose S is a thread a lane with a
# scan and a copy and whose X reads every table from global memory (as
# 14fafdd's): S's scan, memset and copy skipped; X's reciprocal a
# constant; every step of X reading table 0
FROM_BASE = {"s_quad"}
BASE_VARIANTS = {
    "sdiag_nocopy": ("ase.cu", [
        ("  ase_scan_kernel<<<1, SCAN_THREADS, 0, st>>>",
         "  if (false) ase_scan_kernel<<<1, SCAN_THREADS, 0, st>>>"),
        ("cudaMemsetAsync(payload, 0, (size_t)K * cap * 2, st)", "cudaSuccess"),
        ("  ase_copy_kernel<<<", "  if (false) ase_copy_kernel<<<")]),
    "xdiag_nodiv": ("ans2_encode.cu", [("f ? 0xFFFFFFFFu / f : 0u", "f ? 0x40000u : 0u")]),
    "xdiag_onetable": ("ans2_encode.cu", [("entry(freq, cum, snapshot_index(",
                                           "entry(freq, cum, 0u * snapshot_index(")]),
    # kernel W of a base with a memset and three launches (1697712): the
    # counts all ones with the walk skipped; the normalize replaced by a
    # copy of the counts' low bits
    "wdiag_nowalk": ("ans2_encode.cu", [
        ("  ans2_walk_kernel<<<1, NORM_THREADS, 0, s>>>",
         "  if (false) ans2_walk_kernel<<<1, NORM_THREADS, 0, s>>>"),
        ("const uint32_t f = normalize(counts[at], sc, c);",
         "const uint32_t f = normalize(1ull, sc, c);")]),
    "wdiag_norm1": ("ans2_encode.cu", [
        ("const uint32_t f = normalize(counts[at], sc, c);",
         "const uint32_t f = (uint32_t)counts[at];\n  c = f;")]),
}


def build_lib(name: str, csrc: Path, edits=(), only: str | tuple = ()
              ) -> tuple[Path | None, str]:
    """Copy csrc (of its .cu files only `only`, a name or a tuple of names,
    if given) into build/compare/<name>/csrc, apply the edits, build it
    with build.build's nvcc flags. -> (library, nvcc log); (None, "") where
    csrc has none of `only`."""
    dst = OUT_ROOT / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst / "csrc")
    if only:
        keep = (only,) if isinstance(only, str) else only
        for p in (dst / "csrc").glob("*.cu"):
            if p.name not in keep:
                p.unlink()
        if not any((dst / "csrc").glob("*.cu")):
            return None, ""
    for fname, subs in edits:
        p = dst / "csrc" / fname
        text = p.read_text()
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name}: {fname} lacks {old!r}")
            text = text.replace(old, new)
        p.write_text(text)
    path = build.build(dst / "csrc", dst / "lib")
    return path, (path.parent / "nvcc.log").read_text()


def load(path: Path) -> ctypes.CDLL:
    """The library at build/compare/<name>/lib/<hash>/, its entry points
    typed; lib.h_geometry: kernel H's CHUNK and TILE as its sources have
    them (encode_geometry's arguments), where it has that kernel."""
    lib = ctypes.CDLL(str(path))
    sigs = dict(build.SIGNATURES)
    if hasattr(lib, "ct_lz_clamp"):
        sigs.update(OLD_LZ_SIGNATURES)
    ase = path.parents[2] / "csrc" / "ase.cu"
    lib.old_s = ase.exists() and "void* offsets, void* bits, void* payload" in ase.read_text()
    if lib.old_s:
        sigs["ct_ase_encode"] = OLD_S_SIGNATURE
    lib.seg_scale = 1.0
    lib.w_alloc1 = False
    ans2 = path.parents[2] / "csrc" / "ans2_encode.cu"
    ans2 = ans2.read_text() if ans2.exists() else ""
    lib.old_w = "void* hist, void* counts" in ans2
    lib.old_x = "const void* entries, void* ev" not in ans2
    if lib.old_w:
        sigs["ct_ans2_model"] = OLD_W_SIGNATURE
    o1 = path.parents[2] / "csrc" / "o1_encode.cu"
    lib.o1_flag = o1.exists() and "void* flag" in o1.read_text()
    if o1.exists() and not lib.o1_flag:
        sigs.update(OLD_O1_SIGNATURES)
    if lib.old_x:
        sigs["ct_ans2_encode"] = OLD_X_SIGNATURE
    lz = path.parents[2] / "csrc" / "lz_encode.cu"
    lib.old_walk = lz.exists() and "ct_lz_walk(const void* step" in lz.read_text()
    if lib.old_walk:
        sigs["ct_lz_walk"] = OLD_WALK_SIGNATURE
    for name, args in sigs.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = args
            fn.restype = ctypes.c_int
    src = path.parents[2] / "csrc" / "huffman_encode.cu"
    src = src.read_text() if src.exists() else ""
    found = {key: re.search(rf"constexpr int {key.upper()} = (\d+);", src)
             for key in ("chunk", "tile")}
    if all(found.values()):
        lib.h_geometry = {key: int(m.group(1)) for key, m in found.items()}
    return lib


def has_kernel(lib, kern: str) -> bool:
    entry = ENTRY[kern]
    return any(hasattr(lib, e) for e in (entry if isinstance(entry, tuple) else (entry,)))


def old_lz(lib) -> bool:
    """The library has the three-launch Q and the one-launch R."""
    return hasattr(lib, "ct_lz_clamp")


def corpus(name: str) -> bytes:
    return (ROOT / "data" / name).read_bytes()


def to_dev(data: bytes, dev) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(dev)


def rcx_shape(data: bytes, mode: str, dev, lanes=None):
    n = len(data)
    k, inc, cl, cbits = rcx_params(n, lanes=lanes, mode=mode)
    wlog = 0 if mode == "ratio" else 2
    stride = -(-n // k)
    x2d = layout.pad2d_chunked(to_dev(data, dev), k, stride)
    lens = layout.lane_lengths(n, k, stride, dev)
    args = (inc, 1 << cl, cbits, wlog)
    ev = rcx_kernels.encode_events(x2d, lens, *args)
    rows, sizes = expand.materialize_rows(ev)
    words = layout.decode_words(rows, sizes)
    return dict(n=n, k=k, stride=stride, x2d=x2d, lens=lens, args=args, ev=ev,
                rows=rows, sizes=sizes, words=words)


def interleaved(data: bytes, k: int, dev):
    n = len(data)
    stride = -(-n // k)
    return (n, stride, layout.pad2d_interleaved(to_dev(data, dev), k, stride),
            layout.lane_lengths_interleaved(n, k, stride, dev))


def cases(dev, only: str = ""):
    """-> [(kernel, shape, make(lib) -> (launch, output))]: each launch
    writes into its own output buffer. With `only`, the inputs of the other
    kernels are not made."""
    out = []
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731

    def want(letters: str) -> bool:
        return not only or any(c in only for c in letters)

    if want("STUV"):
        out += ase_o1_cases(dev, stream, only)
    if want("WXY"):
        out += ans2_cases(dev, stream)
    if want("Z"):
        out += z_cases(dev, stream)
    if want("K"):
        out += k_cases(dev, stream)
    if not want("ABCDEFGHIJLMNPQR"):
        return out
    rcx_at = [("kennedy.xls", "balanced"), ("grammar.lsp", "balanced"),
              ("fields.c", "balanced"), ("cp.html", "balanced"),
              ("alice29.txt", "ratio"), ("ptt5", "ratio"),
              ("kennedy.xls", "ratio")]
    shapes = [(f"{f} {m}", rcx_shape(corpus(f), m, dev)) for f, m in rcx_at]
    shapes.append(("alice29.txt[:40000] K=32768",
                   rcx_shape(corpus("alice29.txt")[:40000], "balanced", dev,
                             lanes=32768)))
    for label, s in shapes:
        def enc(lib, s=s):
            ev = torch.empty_like(s["ev"])
            return (lambda: lib.ct_rcx_encode(
                s["x2d"].data_ptr(), s["lens"].data_ptr(), ev.data_ptr(), None, 1,
                s["k"], s["stride"], *s["args"], stream())), ev

        def dec(lib, s=s):
            o = torch.zeros(s["k"] * s["stride"], dtype=torch.uint8, device=dev)
            w = s["words"]
            return (lambda: lib.ct_rcx_decode(
                w.data_ptr(), s["lens"].data_ptr(), o.data_ptr(), None, 1, s["k"],
                w.shape[0], s["stride"], *s["args"], stream())), o

        out += [("A", label, enc), ("C", label, dec)]
    b_grids = {f"{f} (rcx)": s["ev"] for f, s in
               ((label.split()[0], s) for label, s in shapes[:2])}
    # the longest run the field holds, in one lane: the warp's long-run path
    one = np.zeros((3, 1), np.uint32)
    one[1, 0] = (1 << 31) | (0x5A << 23) | ((1 << 22) - 1)
    b_grids["one lane, a run of 2^22 - 1 bytes"] = torch.from_numpy(
        one.view(np.int32)).to(dev)

    for f in ("kennedy.xls", "fields.c"):
        data = corpus(f)
        k, inc, cl = rcq_params(len(data))
        n, stride, x2d, lens = interleaved(data, k, dev)
        ev0 = rcq_kernels.encode_events(x2d, lens, inc, 1 << cl)
        if f == "fields.c":
            b_grids[f"{f} (rcq)"] = ev0
        words = layout.decode_words(*expand.materialize_rows(ev0))

        def enc(lib, a=(x2d, lens, ev0, k, stride, inc, 1 << cl)):
            ev = torch.empty_like(a[2])
            return (lambda: lib.ct_rcq_encode(a[0].data_ptr(), a[1].data_ptr(),
                                              ev.data_ptr(), *a[3:], stream())), ev

        def dec(lib, a=(words, lens, k, stride, inc, 1 << cl)):
            o = torch.zeros(a[2] * a[3], dtype=torch.uint8, device=dev)
            return (lambda: lib.ct_rcq_decode(a[0].data_ptr(), a[1].data_ptr(),
                                              o.data_ptr(), a[2], a[0].shape[0],
                                              *a[3:], stream())), o

        out += [("D", f, enc), ("E", f, dec)]

    for label, ev in b_grids.items():
        out += [("B", f"{label} through the wrapper", partial(b_wrapper, ev=ev)),
                ("B", f"{label} passes", partial(b_passes, ev=ev))]

    lane1 = np.random.default_rng(7).integers(0, 256, 200_000, np.uint8).tobytes()
    for f in ("kennedy.xls", "grammar.lsp", "alice29.txt", "lcet10.txt",
              "200,000 random bytes lanes=1"):
        data = lane1 if f.endswith("lanes=1") else corpus(f)
        k = 1 if f.endswith("lanes=1") else rans_ops.pick_lanes(len(data))
        n, stride, x2d, lens = interleaved(data, k, dev)
        freq, cum = rans_ops.tables(rans_ops.static_freqs(x2d.reshape(-1)[:n]),
                                    dev)
        ev0, st = rans_kernels.encode_events(x2d, lens, freq, cum)
        rrows = rans_ops.word_rows(*rans_ops.lane_words(ev0))
        lengths, tab = huffman_ops.encoder_table(x2d.reshape(-1)[:n])
        payload, counts, _ = huffman_kernels.encode_stream(x2d, lens, tab)
        hrows = rans_ops.word_rows(huffman_ops.stream_words(payload, counts),
                                   counts)
        lim, bas, perm = huffman_ops.decoder_tables(lengths, dev)

        def f_enc(lib, a=(x2d, lens, freq, cum, ev0, k, stride)):
            ev = torch.empty_like(a[4])
            so = torch.empty(a[5], dtype=torch.int32, device=dev)
            return (lambda: lib.ct_rans_encode(
                a[0].data_ptr(), a[1].data_ptr(), a[2].data_ptr(), a[3].data_ptr(),
                ev.data_ptr(), so.data_ptr(), a[5], a[6], stream())), (ev, so)

        def g_dec(lib, a=(st, rrows, lens, freq, cum, k, stride)):
            o = torch.zeros(a[5] * a[6], dtype=torch.uint8, device=dev)
            return (lambda: lib.ct_rans_decode(
                a[0].data_ptr(), a[1].data_ptr(), a[2].data_ptr(), a[3].data_ptr(),
                a[4].data_ptr(), o.data_ptr(), a[5], a[1].shape[0], a[6],
                stream())), o

        def i_dec(lib, a=(hrows, lens, lim, bas, perm, k, stride)):
            o = torch.zeros(a[5] * a[6], dtype=torch.uint8, device=dev)
            return (lambda: lib.ct_huffman_decode(
                a[0].data_ptr(), a[1].data_ptr(), a[2].data_ptr(), a[3].data_ptr(),
                a[4].data_ptr(), o.data_ptr(), a[5], a[0].shape[0], a[6],
                stream())), o

        out += [("F", f, f_enc), ("G", f, g_dec),
                ("H", f"{f} through the wrapper", partial(h_wrapper, a=(x2d, lens, tab))),
                # its three launches alone: the queued timing does not see
                # the wrapper's allocations
                ("H", f"{f} passes", partial(h_wrapper, a=(x2d, lens, tab))),
                ("I", f, i_dec)]

    def bwt(f):
        return ctt.compress(corpus(f), codec="blocksort", device=dev, block_log2=19)

    stage = ctt.compress(ctt.compress(bwt("kennedy.xls"), codec="mtf1", device=dev),
                         codec="rle0", device=dev)
    concat = b"".join(corpus(f) for f in CANTERBURY)
    for label, data, k, static in (
            ("kennedy.xls adaptive_range", corpus("kennedy.xls"), None, False),
            ("kennedy.xls static_range", corpus("kennedy.xls"), None, True),
            ("kennedy.xls pipeline coder stage", stage, None, False),
            ("11 files concatenated", concat, None, False),
            ("grammar.lsp adaptive_range", corpus("grammar.lsp"), None, False),
            ("kennedy.xls adaptive_range K=8192", corpus("kennedy.xls"), 8192, False),
            ("kennedy.xls adaptive_range K=65536", corpus("kennedy.xls"), 65536, False)):
        out += range_cases(label, data, k, static, dev, stream)

    for label, data, mtf1 in (("kennedy.xls pipeline mtf1 stage", bwt("kennedy.xls"), True),
                              ("kennedy.xls mtf", corpus("kennedy.xls"), False),
                              ("grammar.lsp pipeline mtf1 stage", bwt("grammar.lsp"), True)):
        n = len(data)
        x = mtf_ops.pad_blocks(to_dev(data, dev))
        ranks = mtf_ops.pad_blocks(mtf_kernels.encode_ranks(x, n, mtf1))
        for kern, src in (("M", x), ("N", ranks)):
            def mtf(lib, a=(src, n, mtf1), entry=ENTRY[kern]):
                o = torch.zeros_like(a[0])
                return (lambda: getattr(lib, entry)(
                    a[0].data_ptr(), o.data_ptr(), a[1], a[0].shape[0], int(a[2]),
                    stream())), o.view(-1)[:a[1]]
            out.append((kern, label, mtf))
    rng = np.random.default_rng(601)
    for label, data, sl in (
            ("kennedy.xls", corpus("kennedy.xls"), 17),
            ("grammar.lsp", corpus("grammar.lsp"), 17),
            ("fields.c at seg_log2 7", corpus("fields.c"), 7),
            ("70,000 zero bytes", bytes(70_000), 17),
            ("200,000 random bytes", rng.integers(0, 256, 200_000, np.uint8).tobytes(), 17),
            ("a 2^14-byte CT-SB superblock", concat[:1 << 14], 17)):
        out += lz_cases(label, data, sl, dev)
    return out


def ase_o1_cases(dev, stream, only: str = ""):
    """S and T (CT-ASE1, interleaved lanes) and U and V (CT-RC3, chunked
    lanes) at kennedy.xls, alice29.txt, grammar.lsp and the first 2^14-byte
    superblock of CT-SB over the concatenated corpus, each at
    pick_lanes(n) lanes (256, 64, 2 and 8); U and V also at kennedy.xls
    over 2,048 lanes (V's lanes two a thread, their state in scratch) and
    65,536 (the u32 table). The inputs are made through this tree's
    wrappers; V's state scratch is sized for either tree (7 words a lane)."""
    out = []
    at = sx_shapes()
    for i, (label, data, k, _) in enumerate(
            at if not only or any(c in only for c in "ST") else ()):
        n, stride, x2d, lens = interleaved(data, k or pick_lanes(len(data)), dev)
        k = x2d.shape[1]
        cap = ase_ops.words_cap(stride)
        payload, bits = ase_kernels.encode_words(x2d, lens)
        counts = ((bits.to(torch.int64) + 15) // 16)
        words = payload[:int(counts.sum())].contiguous()
        bases = (torch.cumsum(counts, 0) - counts).to(torch.int32)
        counts = counts.to(torch.int32)
        shape = f"{label} (K={k}, stride {stride})"

        def s_enc(lib, a=(x2d, lens, k, stride, cap)):
            x2d, lens, k, stride, cap = a
            pay = torch.empty(k * cap, dtype=torch.int16, device=dev)
            bts = torch.empty(k, dtype=torch.int32, device=dev)
            if lib.old_s:
                scratch = torch.empty(k * cap, dtype=torch.int16, device=dev)
                cnt, off = torch.empty((2, k), dtype=torch.int32, device=dev)
                return (lambda: lib.ct_ase_encode(
                    x2d.data_ptr(), lens.data_ptr(), scratch.data_ptr(), cnt.data_ptr(),
                    off.data_ptr(), bts.data_ptr(), pay.data_ptr(), k, stride, cap,
                    stream())), (pay, bts)
            seg = max(1, round(ase_ops.segment_steps(k, stride) * lib.seg_scale))
            scratch = torch.empty(ase_ops.segment_scratch_words(k, stride, seg),
                                  dtype=torch.int32, device=dev)
            return (lambda: lib.ct_ase_encode(
                x2d.data_ptr(), lens.data_ptr(), scratch.data_ptr(), bts.data_ptr(),
                pay.data_ptr(), k, stride, seg, stream())), (pay, bts)

        def t_dec(lib, a=(words, bases, counts, lens, k, stride)):
            o = torch.zeros(a[4] * a[5], dtype=torch.uint8, device=dev)
            return (lambda: lib.ct_ase_decode(
                a[0].data_ptr(), a[0].numel(), a[1].data_ptr(), a[2].data_ptr(),
                a[3].data_ptr(), o.data_ptr(), *a[4:], stream())), o

        out.append(("S", shape, s_enc))
        if i < 4:
            out.append(("T", shape, t_dec))
    concat = b"".join(corpus(f) for f in CANTERBURY)
    at = [("kennedy.xls", corpus("kennedy.xls"), None),
          ("alice29.txt", corpus("alice29.txt"), None),
          ("grammar.lsp", corpus("grammar.lsp"), None),
          ("a 2^14-byte CT-SB superblock", concat[:1 << 14], None)]
    at += [("kennedy.xls", corpus("kennedy.xls"), 2048),
           ("kennedy.xls", corpus("kennedy.xls"), 65536)]
    # U alone at kennedy.xls with its passes alternating over chunks of
    # U_SMALL_CHUNK steps, and at lcet10.txt (K = 128: between the lane
    # counts timed where t0's sums are kept by atomics and by the scan)
    at = [a + (None,) for a in at]
    u_alone = [("kennedy.xls", corpus("kennedy.xls"), None, U_SMALL_CHUNK),
               ("lcet10.txt", corpus("lcet10.txt"), None, None)]
    for i, (label, data, k, chunk) in enumerate(at + u_alone):
        n = len(data)
        k = k or pick_lanes(n)
        steps = -(-n // k)
        x2d = layout.pad2d_chunked(to_dev(data, dev), k, steps)
        lens = layout.lane_lengths(n, k, steps, dev)
        params = (o1_ref.pick_inc(k), o1_ref.LIMIT1_LOG2, o1_ref.LIMIT0_LOG2,
                  o1_ref.BLEND_LOG2)
        wide = o1_ops.table_wide(k, *params[:2])
        ev0 = o1_kernels.encode_events(x2d, lens, *params)
        words = layout.decode_words(*expand.materialize_rows(ev0))
        shape = f"{label} (K={k}, L={steps}{', u32 table' if wide else ''})"
        if chunk:
            shape = f"{label} (K={k}, L={steps}, U in chunks of {chunk} steps)"
        chunk = chunk or o1_kernels.default_chunk_steps(k, steps)

        def scratch(k=k, wide=wide):
            """-> (t1 and state scratch, kept alive by the caller; their
            pointers, or None)."""
            t = (torch.empty(256 * 256, dtype=torch.int32, device=dev) if wide else None,
                 torch.empty(7 * k, dtype=torch.int32, device=dev)
                 if k > o1_kernels.CTA_LANES else None)
            return t, [None if x is None else x.data_ptr() for x in t]

        def u_enc(lib, a=(x2d, lens, ev0, k, steps, chunk, *params, int(wide)),
                  scratch=scratch):
            ev = torch.empty_like(a[2])
            keep, p = scratch()
            k, steps, chunk = a[3:6]
            st = torch.empty(5 * k, dtype=torch.int32, device=dev)
            trip = torch.empty((2, chunk, 3, k), dtype=torch.int32, device=dev)
            mstate = torch.empty(o1_kernels.MODEL_WORDS + o1_kernels.T1_NARROW_WORDS,
                                 dtype=torch.int32, device=dev)
            flag = torch.empty(1, dtype=torch.int64, device=dev)
            keep += (st, trip, mstate, flag)
            # a tree whose U and V take the flag of a step with t = 0
            fl = (flag.data_ptr(),) if lib.o1_flag else ()
            return (lambda keep=keep: lib.ct_o1_encode(
                a[0].data_ptr(), a[1].data_ptr(), ev.data_ptr(), p[0], st.data_ptr(),
                trip.data_ptr(), mstate.data_ptr(), *fl, *a[3:], stream())), ev

        def v_dec(lib, a=(words, lens, n, k, steps, *params, int(wide)),
                  scratch=scratch):
            o = torch.empty(a[2], dtype=torch.uint8, device=dev)
            keep, p = scratch()
            flag = torch.empty(1, dtype=torch.int64, device=dev)
            keep += (flag,)
            fl = (flag.data_ptr(),) if lib.o1_flag else ()
            return (lambda keep=keep: lib.ct_o1_decode(
                a[0].data_ptr(), a[1].data_ptr(), o.data_ptr(), *p, *fl, a[3],
                a[0].shape[0], *a[4:], stream())), o

        out.append(("U", shape, u_enc))
        if i < len(at):
            out.append(("V", shape, v_dec))
    return out


def sx_shapes():
    """[(label, data, K or None for pick_lanes(n), refresh_log2 or None for
    the codec's default)]: S's and X's shapes. kennedy.xls (K = 256),
    alice29.txt (64), grammar.lsp (2), the first 2^14-byte superblock of
    CT-SB over the concatenated corpus (8), ptt5 (128), 200,000 random bytes
    (64), kennedy.xls at 2,048 and 65,536 lanes; X also grammar.lsp at
    refresh_log2 0 (a table a step)."""
    concat = b"".join(corpus(f) for f in CANTERBURY)
    rand = np.random.default_rng(20).integers(0, 256, 200_000, np.uint8).tobytes()
    return [("kennedy.xls", corpus("kennedy.xls"), None, None),
            ("alice29.txt", corpus("alice29.txt"), None, None),
            ("grammar.lsp", corpus("grammar.lsp"), None, None),
            ("a 2^14-byte CT-SB superblock", concat[:1 << 14], None, None),
            ("ptt5", corpus("ptt5"), None, None),
            ("200,000 random bytes", rand, None, None),
            ("kennedy.xls", corpus("kennedy.xls"), 2048, None),
            ("kennedy.xls", corpus("kennedy.xls"), 65536, None)]


def ans2_shapes():
    """[(label, data, K or None, refresh_log2 or None, limit_log2)]: W's, X's
    and Y's shapes. `sx_shapes()` at the codec's limit_log2, then
    grammar.lsp at refresh_log2 0 (a table a step), kennedy.xls at
    limit_log2 9 (a rescale every window) and 63 (none), and 200,000 zero
    bytes (one symbol: runs for W's histograms)."""
    lim = ans2_ref.ANS2_LIMIT_LOG2_DEFAULT
    ken = corpus("kennedy.xls")
    return ([(*s, lim) for s in sx_shapes()]
            + [("grammar.lsp", corpus("grammar.lsp"), None, 0, lim),
               ("kennedy.xls", ken, None, None, 9),
               ("kennedy.xls", ken, None, None, 63),
               ("200,000 zero bytes", bytes(200_000), None, None, lim)])


def w_tables(entries):
    """W's entries -> (freqs, cums) int32, as a base as 1697712 writes
    them, and the entries."""
    return (*(t.to(torch.int32) for t in ans2_ops.entry_tables(entries)), entries)


def ans2_cases(dev, stream):
    """W, X and Y (CT-ANS2, interleaved lanes) at `ans2_shapes()`, at the
    codec's inc; the inputs made through this tree's W and X. A library
    whose W takes hist and counts scratch and whose X reads (freqs, cums)
    (as 1697712's: `lib.old_w`, `lib.old_x`) is called through those
    entries; W's outputs are compared as (freqs, cums), and the entries too
    where both libraries write them. Y's state scratch is given at every K,
    so either tree takes it."""
    out = []
    inc = ans2_ref.ANS2_INC_DEFAULT
    for label, data, k, r_log2, limit in ans2_shapes():
        k = k or pick_lanes(len(data))
        n, steps, x2d, lens = interleaved(data, k, dev)
        if r_log2 is None:
            r_log2 = ans2_ref.default_refresh_log2(k, n)
        r = ans2_ops.refresh_eff(r_log2, steps)
        n_snap = ans2_ops.n_snapshots(steps, r)
        entries = ans2_kernels.window_tables(x2d, n, inc, limit, r_log2)
        freqs, cums = (t.to(torch.int32) for t in ans2_ops.entry_tables(entries))
        ev, states = ans2_kernels.encode_events(x2d, lens, entries, r_log2)
        words = ans2_ops.stream_words(ev).to(torch.int16)
        shape = (f"{label} (K={k}, {steps} steps, {n_snap} windows"
                 + (f", refresh_log2 {r_log2}" if r_log2 == 0 else "")
                 + (f", limit_log2 {limit}" if limit != ans2_ref.ANS2_LIMIT_LOG2_DEFAULT
                    else "") + ")")

        def w_model(lib, a=(x2d, n, k, steps, inc, limit, r, n_snap)):
            ns = a[7]
            if lib.old_w:
                f, c = (torch.empty((ns, 256), dtype=torch.int32, device=dev)
                        for _ in range(2))
                hist = torch.empty((ns, 256), dtype=torch.int32, device=dev)
                counts = torch.empty((ns, 256), dtype=torch.int64, device=dev)
                return (lambda: lib.ct_ans2_model(
                    a[0].data_ptr(), hist.data_ptr(), counts.data_ptr(), f.data_ptr(),
                    c.data_ptr(), *a[1:], stream())), (f, c)
            rows, nbytes = ans2_kernels.model_scratch(a[1], a[2], a[3], a[6], ns)
            scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
            e = torch.empty((ns, 256), dtype=torch.int64, device=dev)
            return (lambda: lib.ct_ans2_model(
                a[0].data_ptr(), scratch.data_ptr(), e.data_ptr(), *a[1:], rows,
                stream())), lambda: w_tables(e)

        def w_wrapper(lib, a=(x2d, n, k, steps, inc, limit, r, n_snap)):
            """W as a wrapper of its library's interface runs it, its
            allocations in each call: 1697712's four tensors (hist, counts,
            freqs, cums), this tree's `ans2_kernels.model_launch` (entries
            and scratch), or for w_alloc1 one allocation with two views."""
            res = {}

            def go():
                if lib.old_w:
                    hist = torch.empty((a[7], 256), dtype=torch.int32, device=dev)
                    counts = torch.empty((a[7], 256), dtype=torch.int64, device=dev)
                    f = torch.empty((a[7], 256), dtype=torch.int32, device=dev)
                    c = torch.empty_like(f)
                    res["out"] = (f, c)
                    return lib.ct_ans2_model(a[0].data_ptr(), hist.data_ptr(),
                                             counts.data_ptr(), f.data_ptr(), c.data_ptr(),
                                             *a[1:], stream())
                if lib.w_alloc1:
                    rows, nbytes = ans2_kernels.model_scratch(a[1], a[2], a[3], a[6], a[7])
                    buf = torch.empty(a[7] * 2048 + nbytes, dtype=torch.uint8, device=dev)
                    e = buf[:a[7] * 2048].view(torch.int64).view(a[7], 256)
                    res["out"] = e
                    return lib.ct_ans2_model(a[0].data_ptr(), buf[a[7] * 2048:].data_ptr(),
                                             e.data_ptr(), *a[1:], rows, stream())
                try:
                    res["out"] = ans2_kernels.model_launch(a[0], a[1], a[4], a[5], a[6],
                                                           a[7], lib)
                except RuntimeError:    # a variant that refuses the shape
                    return 1
                return 0
            return go, lambda: (res["out"] if lib.old_w else w_tables(res["out"]))

        def x_enc(lib, a=(x2d, lens, freqs, cums, entries, k, steps, r)):
            e = torch.empty((a[6], a[5]), dtype=torch.int32, device=dev)
            st = torch.empty(a[5], dtype=torch.int32, device=dev)
            tables = a[2:4] if lib.old_x else a[4:5]
            return (lambda: lib.ct_ans2_encode(
                a[0].data_ptr(), a[1].data_ptr(), *(t.data_ptr() for t in tables),
                e.data_ptr(), st.data_ptr(), *a[5:], stream())), (e, st)

        def y_dec(lib, a=(words, states, n, k, steps, inc, limit, r)):
            o = torch.empty(a[2], dtype=torch.uint8, device=dev)
            scratch = torch.empty(a[3], dtype=torch.int32, device=dev)
            return (lambda scratch=scratch: lib.ct_ans2_decode(
                a[0].data_ptr(), a[0].numel(), a[1].data_ptr(), scratch.data_ptr(),
                o.data_ptr(), *a[2:], stream())), o

        out += [("W", shape, w_model), ("W", f"{shape} through the wrapper", w_wrapper),
                ("X", shape, x_enc), ("Y", shape, y_dec)]
    return out


def lz_cases(label: str, data: bytes, seg_log2: int, dev):
    """P, Q and R at one shape, their inputs made through this tree's
    wrappers (the match table, P's tokens, Q's payload). P is timed as its
    device work queued back to back (an older tree's: lz_ops.walk_inputs'
    tensor ops, the zero fill of its outputs and its launch) and through a
    wrapper of each interface (allocations included). Q is timed as its
    launches alone (a library with host reads inside gets its grid width
    and payload length read beforehand) and through a wrapper of each
    interface, host reads included; its outputs compared are the blocks and
    the sizes."""
    n = len(data)
    rows, lens = lz_ops.segment_rows(to_dev(data, dev), seg_log2)
    lcp, cand = lz_ops.match_table(rows, lens)
    mpos, mlen, moff, count = lz_kernels.walk(lcp, cand, lens)
    ns, w = rows.shape
    tcap = mpos.shape[1]
    geo = lz_kernels.walk_geometry(w)
    payload, sizes = lz_kernels.serialize(rows, lens, mpos, mlen, moff, count)
    bases = sizes.cumsum(0) - sizes
    s = min(1 << seg_log2, n)
    shape = f"{label} ({ns} segments, {int(count.sum())} matches)"
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    args = (rows, mpos, mlen, moff, count, lens)   # the closures keep them alive

    def p_call(lib, fresh: bool):
        """-> (call, outputs) of P into buffers allocated once, or (fresh) a
        call as its wrapper makes it, allocations included."""
        res = {}

        def alloc():
            if lib.old_walk:
                return (torch.empty((ns, w), dtype=torch.int32, device=dev),
                        *(torch.zeros((ns, tcap), dtype=torch.int32, device=dev)
                          for _ in range(3)),
                        torch.empty(ns, dtype=torch.int32, device=dev))
            return (torch.empty(ns * geo.row_bytes, dtype=torch.uint8, device=dev),
                    torch.empty(1 if geo.staged else ns * geo.blocks, dtype=torch.int32,
                                device=dev),
                    *torch.empty((3, ns, tcap), dtype=torch.int32, device=dev).unbind(0),
                    torch.empty(ns, dtype=torch.int32, device=dev))
        kept = alloc()

        def go():
            b = alloc() if fresh else kept
            if lib.old_walk:
                step, off = lz_ops.walk_inputs(lcp, cand, lens)
                if not fresh:
                    for t in b[1:4]:
                        t.zero_()
                res["out"] = b[1:5]
                return lib.ct_lz_walk(step.data_ptr(), off.data_ptr(),
                                      *(t.data_ptr() for t in b), ns, w, tcap, stream())
            res["out"] = b[2:6]
            return lib.ct_lz_walk(lcp.data_ptr(), cand.data_ptr(), lens.data_ptr(),
                                  *(t.data_ptr() for t in b), ns, w, geo.lb, 1, tcap,
                                  stream())
        return go, lambda: res["out"]

    def q_launches(lib, old: bool):
        """-> (launch, output callable) of Q's launches into fresh buffers."""
        p = [t.data_ptr() for t in args]
        if old:
            tmax = int(count.max()) + 1
            clamped = torch.empty_like(mlen)
            size = torch.empty((ns, tmax), dtype=torch.int64, device=dev)
            ends = torch.empty(ns * tmax, dtype=torch.int64, device=dev)
            total = int(sizes.sum())
            pay = torch.empty(total, dtype=torch.uint8, device=dev)

            def go():
                rc = lib.ct_lz_clamp(p[0], p[1], p[2], p[3], p[4], clamped.data_ptr(), ns, w,
                                     tcap, tmax, stream())
                rc = rc or lib.ct_lz_sizes(p[1], clamped.data_ptr(), p[4], p[5],
                                           size.data_ptr(), ns, tcap, tmax, stream())
                torch.cumsum(size.view(-1), 0, out=ends)
                return rc or lib.ct_lz_write(p[0], p[1], clamped.data_ptr(), p[3], p[4], p[5],
                                             ends.data_ptr(), size.data_ptr(), pay.data_ptr(),
                                             ns, w, tcap, tmax, stream())
            return go, lambda: (pay, size.sum(1))
        clamped = torch.empty_like(mlen)
        tstart = torch.empty((ns, tcap + 1), dtype=torch.int32, device=dev)
        sz = torch.empty(ns, dtype=torch.int64, device=dev)
        pay = torch.empty(ns * lz_kernels.payload_bound(w), dtype=torch.uint8, device=dev)

        def go():
            return lib.ct_lz_serialize(p[0], p[5], p[1], p[2], p[3], p[4], clamped.data_ptr(),
                                       tstart.data_ptr(), sz.data_ptr(), pay.data_ptr(), ns, w,
                                       tcap, stream())
        return go, lambda: (pay[:int(sz.sum())], sz)

    def q_passes(lib):
        return q_launches(lib, old_lz(lib))

    def q_wrapper(lib):
        """Q as its wrapper runs it: an older tree's reads count.max() and
        the payload's length on the host between its launches."""
        res = []
        old = old_lz(lib)
        p = [t.data_ptr() for t in args]

        def go():
            if old:
                tmax = int(count.max()) + 1
                clamped = torch.empty_like(mlen)
                rc = lib.ct_lz_clamp(p[0], p[1], p[2], p[3], p[4], clamped.data_ptr(), ns, w,
                                     tcap, tmax, stream())
                size = torch.empty((ns, tmax), dtype=torch.int64, device=dev)
                rc = rc or lib.ct_lz_sizes(p[1], clamped.data_ptr(), p[4], p[5],
                                           size.data_ptr(), ns, tcap, tmax, stream())
                ends = size.view(-1).cumsum(0)
                pay = torch.empty(int(ends[-1]), dtype=torch.uint8, device=dev)
                rc = rc or lib.ct_lz_write(p[0], p[1], clamped.data_ptr(), p[3], p[4], p[5],
                                           ends.data_ptr(), size.data_ptr(), pay.data_ptr(), ns,
                                           w, tcap, tmax, stream())
                res[:] = [pay, size.sum(1)]
                return rc
            launch, outs = q_launches(lib, False)
            rc = launch()
            res[:] = [outs]
            return rc
        return go, lambda: res[0]() if callable(res[0]) else tuple(res)

    def r_launch(lib):
        out = torch.empty(n, dtype=torch.uint8, device=dev)
        err = torch.empty(ns, dtype=torch.int32, device=dev)
        q = [t.data_ptr() for t in (payload, bases, sizes)]
        if old_lz(lib):
            return (lambda: lib.ct_lz_decode(q[0], q[1], q[2], out.data_ptr(), err.data_ptr(),
                                             ns, n, s, stream())), (out, err)
        tc, rounds = lz_kernels.decode_geometry(n, s)
        scratch = lz_kernels.decode_scratch(payload.numel(), ns, n, s, dev)
        sp = [t.data_ptr() for t in scratch]
        return (lambda: lib.ct_lz_decode(q[0], q[1], q[2], *sp, out.data_ptr(), err.data_ptr(),
                                         ns, n, s, tc, rounds, lz_kernels.HOPS,
                                         stream())), (out, err)

    return [("P", f"{shape} launches", lambda lib: p_call(lib, False)),
            ("P", f"{shape} through the wrapper", lambda lib: p_call(lib, True)),
            ("Q", f"{shape} passes", q_passes), ("Q", f"{shape} through the wrapper", q_wrapper),
            ("R", shape, r_launch)]


def lz_table_shapes(dev):
    """The six shapes of Z's and K's cases: -> [(shape, rows, lens)]."""
    rng = np.random.default_rng(601)
    out = []
    for label, data, sl in (
            ("kennedy.xls", corpus("kennedy.xls"), 17),
            ("grammar.lsp", corpus("grammar.lsp"), 17),
            ("fields.c at seg_log2 7", corpus("fields.c"), 7),
            ("70,000 zero bytes", bytes(70_000), 17),
            ("200,000 random bytes", rng.integers(0, 256, 200_000, np.uint8).tobytes(), 17),
            ("kennedy.xls at seg_log2 20", corpus("kennedy.xls"), 20)):
        rows, lens = lz_ops.segment_rows(to_dev(data, dev), sl)
        out.append((f"{label} ({rows.shape[0]} segments of {rows.shape[1]})", rows, lens))
    return out


def tensor_code(fn, rows, lens):
    """make(lib) for a call of tensor code on (rows, lens), whatever the
    library."""
    def make(lib):
        res = {}

        def go():
            res["out"] = fn(rows, lens)
            return 0
        return go, lambda: res["out"]
    return make


def k_cases(dev, stream):
    """K at Z's six shapes and ptt5: its launches queued into buffers
    allocated once, and through a wrapper (its outputs and scratch
    allocated in each call, as lz_kernels.match_v2 does; each call timed
    apart); beside them, as a case of its own, its plain version (v2's
    tensor table)."""
    out = []
    rows, lens = lz_ops.segment_rows(to_dev(corpus("ptt5"), dev), 17)
    ptt5 = (f"ptt5 ({rows.shape[0]} segments of {rows.shape[1]})", rows, lens)
    for shape, rows, lens in lz_table_shapes(dev) + [ptt5]:
        ns, w = rows.shape

        def k(lib, rows=rows, lens=lens, ns=ns, w=w, fresh=False):
            res = {}

            def go():
                if fresh or not res:
                    res["lcp"], res["cand"] = torch.empty(
                        (2, ns, w), dtype=torch.int64, device=dev).unbind(0)
                    res["scratch"] = torch.empty(lz_kernels.match_v2_scratch(ns, w),
                                                 dtype=torch.int32, device=dev)
                return lib.ct_lz_match_v2(rows.data_ptr(), lens.data_ptr(),
                                          res["lcp"].data_ptr(), res["cand"].data_ptr(),
                                          res["scratch"].data_ptr(), ns, w, stream())
            go()
            return go, lambda: (res["lcp"], res["cand"])

        out += [("K", f"{shape} launches", k),
                ("K", f"{shape} through the wrapper", partial(k, fresh=True)),
                ("K", f"{shape} v2 match_table (tensor code)",
                 tensor_code(lz_ops.match_table, rows, lens))]
    return out


def z_cases(dev, stream):
    """Z at its shapes (launches into buffers allocated once), and beside
    it, as cases of its own, its plain version and v2's tensor table on
    the same rows (tensor code: each call timed apart)."""
    out = []
    for shape, rows, lens in lz_table_shapes(dev):
        ns, w = rows.shape

        def z(lib, rows=rows, lens=lens, ns=ns, w=w):
            lcp, cand = torch.empty((2, ns, w), dtype=torch.int64, device=dev).unbind(0)
            return (lambda: lib.ct_lz_match_v1(rows.data_ptr(), lens.data_ptr(), lcp.data_ptr(),
                                               cand.data_ptr(), ns, w, stream())), (lcp, cand)

        out += [("Z", shape, z),
                ("Z", f"{shape} match_table_v1 (tensor code)",
                 tensor_code(lz_ops.match_table_v1, rows, lens)),
                ("Z", f"{shape} v2 match_table (tensor code)",
                 tensor_code(lz_ops.match_table, rows, lens))]
    return out


def range_cases(label: str, data: bytes, k: int | None, static: bool, dev, stream):
    """J and L at one shape: the codec's defaults for n bytes over k lanes
    (pick_lanes(n) when None), made through this tree's wrappers."""
    k = k or pick_lanes(len(data))
    n, stride, x2d, lens = interleaved(data, k, dev)
    x = np.frombuffer(data, np.uint8)
    freqs = torch.from_numpy(normalize_freqs(np.bincount(x, minlength=256), 16).astype(
        np.int32)).to(dev) if static else None
    inc, limit_log2 = (0, 16) if static else adaptive_params_for(k)
    slots = range_ops.slots(freqs, limit_log2, k, inc)
    ev0 = range_kernels.encode_events(x2d, lens, freqs, inc, limit_log2)
    words = layout.decode_words(*expand.materialize_rows(ev0))
    fp = None if freqs is None else freqs.data_ptr()
    shape = f"{label} (K={k}, stride {stride}, {slots} slots)"

    def enc(lib):
        ev = torch.empty_like(ev0)
        return (lambda: lib.ct_rc_exact_encode(
            x2d.data_ptr(), lens.data_ptr(), fp, ev.data_ptr(), k, stride, inc, limit_log2,
            slots, stream())), ev

    def dec(lib):
        o = torch.zeros(k * stride, dtype=torch.uint8, device=dev)
        return (lambda: lib.ct_rc_exact_decode(
            words.data_ptr(), lens.data_ptr(), fp, o.data_ptr(), k, words.shape[0], stride,
            inc, limit_log2, slots, stream())), o

    return [("J", shape, enc), ("L", shape, dec)]


def b_wrapper(lib, ev):
    """Kernel B through its wrapper (may_drop True, the host round trip
    inside)."""
    out = []

    def go():
        out[:] = expand._launch(ev, None, True, lib)
        return 0
    return go, out


def b_passes(lib, ev):
    """Kernel B's two passes alone (may_drop True), the row width fixed."""
    e, k = ev.shape
    rows, sizes = expand.materialize_rows(ev)
    rows, sizes = torch.empty_like(rows), torch.empty_like(sizes)
    stream = torch.cuda.current_stream(ev.device).cuda_stream
    top = torch.empty(1, dtype=torch.int64, device=ev.device)

    def go():
        rc = lib.ct_expand_count(ev.data_ptr(), None, 1, sizes.data_ptr(),
                                 top.data_ptr(), e, k, stream)
        return rc or lib.ct_expand_write(ev.data_ptr(), None, 1, rows.data_ptr(),
                                         e, k, rows.shape[1], stream)
    return go, (rows, sizes)


def h_wrapper(lib, a):
    """Kernel H through its wrapper (huffman_kernels.encode_launch, the
    buffers made in each call)."""
    x2d, lens, tab = a
    stride, k = x2d.shape
    out = []
    geo = huffman_kernels.encode_geometry(stride, k, **lib.h_geometry)

    def go():
        out[:] = huffman_kernels.encode_launch(x2d, lens, tab, geo, lib)
        return 0
    return go, out


def time_turn(go, reps: int, each: bool = False) -> float | None:
    """ms a launch (reps after 2 warm-ups), or None for a refused launch:
    the mean of reps launches queued back to back, or with `each` (a call
    that waits on the host inside, as B's wrapper does) the median of reps
    calls timed one by one."""
    for _ in range(2):
        rc = go()
        if rc != 0:
            print(f"[refused] error {rc}", flush=True)
            return None
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if each:
        ts = []
        for _ in range(reps):
            a.record()
            go()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return float(np.median(ts))
    torch.cuda._sleep(5_000_000)   # the launches queue behind it: no host gaps
    a.record()
    for _ in range(reps):
        go()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def same(x, y) -> bool:
    """Equal outputs; an output given as a callable is computed first."""
    x, y = (v() if callable(v) else v for v in (x, y))
    xs = tuple(x) if isinstance(x, (tuple, list)) else (x,)
    ys = tuple(y) if isinstance(y, (tuple, list)) else (y,)
    return all(torch.equal(a, b) for a, b in zip(xs, ys))


def sass_of_d(path: Path) -> dict:
    """{LPT: SASS instructions} of the one-row rc_encode_kernel instantiations."""
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True,
                          text=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        name, body = block.split("\n", 1)
        # D: LPT, ROUNDS 1, ONE_ROW, G 1, no GMODEL, and RESUME clear where
        # the template has it (kernel O is the same template with it set)
        m = re.search(r"rc_encode_kernelILi(\d+)ELi1ELb1ELi1ELb0E(Lb0E)?E", name)
        if m:
            out[int(m.group(1))] = [re.sub(r"/\*[0-9a-fx]+\*/|;.*$", "", ln).strip()
                                    for ln in body.splitlines() if "/*" in ln]
    return out


def profile_launches(go, reps: int = 20) -> dict:
    """{device launch name: mean device ms a call} over reps calls of go,
    from torch.profiler's trace of the card."""
    from torch.profiler import ProfilerActivity, profile

    go()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            go()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.name.replace("(anonymous namespace)::", "").split("(")[0]
            out[name] = out.get(name, 0.0) + ev.time_range.elapsed_us() / 1e3 / reps
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, type=Path)
    ap.add_argument("--variants", default="")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--profile", default="")
    ap.add_argument("--only", default="")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", type=Path)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_kernels.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    names = ["base", "tree"] + [v for v in a.variants.split(",") if v]

    # with --only among S-Y, the base and this tree build those kernels'
    # sources alone
    only = (tuple(sorted({SOURCE_OF[c] for c in a.only}))
            if a.only and all(c in SOURCE_OF for c in a.only) else ())

    def make(nm):
        if nm == "base":
            return build_lib(nm, a.base / "cpprcoder_tpu_torch" / "csrc", only=only)
        if nm == "tree":
            return build_lib(nm, build.CSRC, only=only)
        base = a.base / "cpprcoder_tpu_torch" / "csrc"
        if nm.endswith("@base"):
            edit = BASE_VARIANTS[nm[:-len("@base")]]
            return build_lib(nm.replace("@", "_"), base, [edit], edit[0])
        src = base if nm in FROM_BASE else build.CSRC
        return build_lib(nm, src, [VARIANTS[nm]], VARIANT_SOURCE[nm.split("_")[0]])

    # every library's nvcc processes at once
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(make, names)))
    libs = {}
    for nm, (path, log) in built.items():
        if path is None:
            print(f"[build] {nm}: has none of {only}: skipped", flush=True)
            continue
        libs[nm] = load(path)
        libs[nm].seg_scale = SEG_SCALE.get(nm, 1.0)
        libs[nm].w_alloc1 = nm == "w_alloc1"
        spills = sorted({ln.split(":")[-1].strip() for ln in log.splitlines()
                         if "spill" in ln and " 0 bytes spill stores" not in ln})
        print(f"[build] {nm}: nonzero spills: {spills}", flush=True)
    report = {"device": torch.cuda.get_device_name(0), "ms": {}, "differs": []}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    report["nvidia_smi"] = smi.stdout.strip()
    if a.sass:
        old = sass_of_d(next((OUT_ROOT / "base" / "lib").rglob("*.so")))
        new = sass_of_d(next((OUT_ROOT / "tree" / "lib").rglob("*.so")))
        report["d_sass_same"] = {lpt: old.get(lpt) == new.get(lpt)
                                 for lpt in sorted(set(old) | set(new))}
        report["d_sass_lines"] = {lpt: len(v) for lpt, v in new.items()}
    for kern, shape, make in cases(dev, a.only):
        if a.only and kern not in a.only:
            continue
        if kern == a.profile and "wrapper" not in shape:
            launches = profile_launches(make(libs["tree"])[0])
            report.setdefault("profile", {})[f"{kern} {shape}"] = launches
            print(f"[profile] {kern} {shape}: " + ", ".join(
                f"{nm} {t:.4f}" for nm, t in launches.items()), flush=True)
        runs = {nm: make(lib) for nm, lib in libs.items() if has_kernel(lib, kern)}
        order = [nm for nm in names + names[::-1] if nm in runs]
        best = {}
        # a call through a wrapper, or of tensor code, waits on the host:
        # more calls a turn, each timed apart
        each = "wrapper" in shape or "tensor code" in shape
        reps = a.reps * 5 if each else a.reps
        for nm in order:
            t = time_turn(runs[nm][0], reps, each)
            if t is not None:
                best[nm] = min(best.get(nm, t), t)
        torch.cuda.synchronize()
        for nm in runs:
            if nm in best and nm != "tree" and not same(runs[nm][1], runs["tree"][1]):
                report["differs"].append(f"{kern} {shape} {nm}")
        report["ms"][f"{kern} {shape}"] = best
        print(f"[time] {kern} {shape}: " + ", ".join(
            f"{nm} {best[nm]:.4f}" if nm in best else f"{nm} refused" for nm in runs),
            flush=True)
    text = json.dumps(report)
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(text)
    print(text)
    if report["differs"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
