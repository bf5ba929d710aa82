#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's ported paths once on one GPU: CT-RCX,
CT-RCQ, CT-ANS1 v2 rANS (the default codec), CT-HUF1 canonical Huffman,
the Config-4 BWT pipeline (CT-PIPE: blocksort, mtf1, rle0,
adaptive_range) with its stages and CT-RC1, CT-LZ4 (slz4), CT-ASE1 (ase),
CT-RC3 (adaptive_o1), CT-ANS2 (adaptive_rans), the resumable CT-RCQ
encoder and CT-SB streaming over every codec, up to a stream of
2^30 + 12,345 bytes, the tooling, and the sharded CT-RCX, CT-RCQ and
CT-RC2 paths over worlds of 1, 2 and 4 ranks.

    python3 chip_smoke.py

Phases, one line each (a failed phase exits non-zero):
  1. env      the card, torch, nvcc and `nvidia-smi` name/power limit;
  2. build    nvcc builds the kernels of cpprcoder_tpu_torch/csrc/;
  3. kernels  each kernel (A, B, C for CT-RCX; D, E for CT-RCQ; F, G for
              rANS; H, I for CT-HUF1) against its plain PyTorch version on
              the card, on seeded inputs at the main paths' shapes and on
              hard cases for the range coders (one-byte runs, runs mixed
              with text, K not a multiple of 32, up to 32,768 lanes, rows
              that halve at nearly every window), for B (a run of 2^22 - 1
              bytes, runs at tile boundaries, first emits in later tiles
              under a mask, K = 100 and 32,768, a given l2) and for G (a
              table entry of f = 2^14, one lane of more than 65,535 words)
              and for H (codes of 15 bits, K = 65,536, lanes of length 0,
              strides of CHUNK - 1 and + 1, lanes whose words start
              mid-u32), exact equality; then both timed with CUDA events
              at kennedy.xls's shape, A and C alone also at grammar.lsp's
              and at alice29.txt's under the ratio preset, D to I alone at
              a small file's (fields.c, grammar.lsp), F, G and H also at
              the 200,000-byte lanes=1 lane (H's container there against
              the oracle's), B through its wrapper at kennedy.xls,
              grammar.lsp (rcx) and fields.c (rcq) and there its two
              passes and its host round trip apart, H as its launches'
              device time and through its wrapper; I also on random word
              rows; rcx and rcq round trips at 32,768 lanes against the
              oracle; J and L (CT-RC1/CT-RC2 encode, decode) at one lane to
              65,536 lanes (across J's and L's CTA and cluster edges), three
              slots a step (limit_log2 > 16, and inc 255 at limit_log2 16,
              where the total passes 2^16), one-byte runs (also over 65,536
              lanes), n not a multiple of K and the static table, the
              containers of those cases and of fields.c at 16,384 to 65,536
              lanes against the oracle, then timed at kennedy.xls's
              adaptive_range shape, the
              pipeline's coder stage there, grammar.lsp, static_range at
              kennedy.xls and the 11 files concatenated (K = 1,024, three
              slots); M and N (MTF, MTF-1 encode, decode) at one byte to
              several blocks, a block cut inside a chunk, a one-byte run,
              random bytes, and segment edges (a swap, and a rank 1 that
              does not move, on every segment's first byte; runs, all 256
              values, a BWT across a block and one byte, short blocks of
              1,023 and 1,025 bytes), then timed at the pipeline's mtf1
              stage at kennedy.xls, mtf alone there and grammar.lsp; O
              (kernel D from a saved state, the flush only when asked) in
              chunks of 1, 63, 64 and 65 steps at K = 1 to 32,768 (8 and
              32 lanes a thread), lanes that first emit chunks later, a
              0xFF-heavy input from a state with pending runs, a
              flush-only launch, and kennedy.xls in 64-step chunks joined
              to D's events, then timed there beside D's one-shot time;
              P, Q and R (CT-LZ4's v2 walk, serializer and decode) at
              kennedy.xls (8 segments of 2^17), grammar.lsp, fields.c at
              seg_log2 7 (88 segments), 70,000 zero bytes and 200,000
              random bytes, and at edges (1 and 13 bytes, seg_log2 0, 3
              and 9, lazy=False, a match of 600 bytes, 300,000 random
              bytes at seg_log2 18, whose blocks R reads from global
              memory), each container also against the v2 oracle's (Q's
              payload zero past its blocks, of the worst-case length); R
              on 5 malformed blocks, with its plain version's error code
              and a zero segment, on 8 segments with segment 3 corrupted
              and on the longest chain of matches; timed at those five
              shapes and R at the last two, the plain versions at
              kennedy.xls; Z (CT-LZ4's v1 match table) against its plain
              version at those shapes and edges and at the distance limit
              (a key's nearest copy 65,535 and 65,536 back, a farther one
              beyond), timed at P's shapes beside the plain version and
              v2's tensor table; K (CT-LZ4's v2 match table) against its
              plain version (v2's tensor table) at those shapes and
              edges, the distance limit and a 2^14-byte CT-SB
              superblock, and against the oracle a segment at a time on
              the 11 files, timed at P's shapes beside the tensor table;
              then slz4's encode parts at kennedy.xls, v2's (K, P, Q;
              the tensor table timed beside K) beside v1's (Z, P, Q);
              S and T (CT-ASE1 encode, decode) on runs
              (every hit at distance 0), all 256 values cycled (a full
              table evicting every step), exactly 64 and 65 distinct
              symbols, n not a multiple of K, K = 1 and K = 65,536; U and
              V (CT-RC3 encode, decode) at limit1_log2 9 (rows halving
              nearly every step), t0 rescaling, n < K, a one-byte run,
              the u32 table (blend 0, limit1_log2 17) at one and four
              lanes, 2,048 and 65,536 lanes (U's model pass and coder
              pass each held to its plain version too), and U over chunks
              of 1 to 300 steps (kennedy.xls in 16); each case's
              container against the oracle's; U and V past the u32 guard
              (fault P7: 4,096 lanes x 4,200 steps of zeros at limits
              32/11, blend 5, and 65,536 x 263 random bytes at limit1_log2
              32 and 33, their counts in 64 bits), held to their plain
              versions (the same events, decoded back, or the same step
              error) and timed, and the 64-bit instantiation beside the
              u32 one at kennedy.xls; then timed at kennedy.xls's
              shapes (K = 256) and grammar.lsp's (K = 2); W, X and Y
              (CT-ANS2's model, coder and decode) and the normalize W and
              Y share (alone, at 255 count vectors against the oracle's)
              at refresh_log2 0 and past bitlen(steps), limit_log2 9,
              n < K, n not a multiple of K, a one-byte run, all 256
              values, K = 1, 32, 64, 16,384, 32,768 and 65,536, more
              words than Y's ring holds, every lane refilling at one
              step, each container against the oracle's, Y on word
              streams cut short, and the model past 2^32 (8,192 lanes x
              4,100 steps of one byte at inc 255: W's tables against the
              oracle's model pass at limit_log2 40, 33, 32, X and Y round
              trips); then timed at kennedy.xls's and grammar.lsp's
              shapes;
  4. main     per codec (rcx, rcq, rans, huffman, static_range,
              adaptive_range, blocksort, mtf, mtf1, rle0, pipeline, slz4,
              ase, adaptive_o1, adaptive_rans),
              with the launch counts set to 0 just before and read just
              after:
              compress/decompress(codec, device="cuda") over the 11
              Canterbury files, byte-identical to the numpy oracle, the
              known container sizes, a round trip; for rcx also the ratio
              preset on three files, for rans also the default codec and a
              lane with a wide word count, for static_range and
              adaptive_range also the 11 files concatenated (2,810,784
              bytes: K = 1,024, limit_log2 17), for slz4 (kernels K, P, Q
              and R, held to the v2 oracle, which its card path writes;
              its backend="ref" is the v1 parse) also the 11 files
              concatenated (22 segments: the C1 row); then the `slz4_v1` path (the 11 files through
              lz_ops.slz4_encode(parse="v1", device="cuda"): Z, P and Q,
              each container the v1 oracle's, 1,140,737 bytes in all, each
              decoded through R); then the
              `resume` path
              (kennedy.xls and fields.c through RCQResumableEncoder,
              checkpointed half-way through pickle and resumed: one-shot
              rcq's container and the oracle's, a round trip) and the
              `stream` path (every ported codec through CT-SB at sb_log2
              14 over the 11 files concatenated, held to the oracle's
              container, which worker processes compute meanwhile, with a
              stream_decode_range across superblock edges; then
              bench/synth.py's stream of 2^30 + 12,345 bytes over rcx and
              rans at sb_log2 25, 33 superblocks: round trips, the tail
              superblock against the oracle's, for rcx the first one too,
              and encode/decode seconds and GB/s). Every kernel of the
              path must have launched. Each call of a kernel's wrapper is
              recorded and timed again afterwards (on the stream path
              timed where it ran): `main_ms` is their sum;
  5. tooling  the CLI (python -m cpprcoder_tpu_torch.cli) as processes of
              their own on the card: compress/decompress -c rans --profile
              --shadow of kennedy.xls and a --stages pipeline on
              grammar.lsp (byte-compared, the containers the codec path's
              and the oracle's), bench -c rans rcx --json (rows that
              round-trip, of the codec path's container sizes); the
              profile report's phases at kennedy.xls (adaptive_range
              encode, rcq and rcx decode) beside the card's name and
              power limit; the host library's static, adaptive, rcq and
              rcx containers against the card's on the 11 files;
  6. parallel the sharded paths (cpprcoder_tpu_torch/parallel/), each run
              alone on the card and the host: first the launch module
              under torchrun, one process at its default 2^24 bytes;
              then the new kernel forms held to their plain versions,
              exactly: the
              lane-range forms of A (one CTA, its global model at cbits
              8, the cluster at 2,048 and 4,096 lanes), D (up to 8,192
              lanes) and J (CTAs of 64 and of 256 coders, three slots),
              and the stepped lane-range forms of C (wlog 0, 1, 2; cbits
              4 and 8) and E, two and four ranks simulated in this
              process, every launch's symbols and state held to the plain
              version's and the joined symbols to the input; then timed
              at kennedy.xls beside the one-shot kernels (a stepped
              form's device time from events around each launch while
              the card is held behind a spin, so that the wrapper's host
              work falls outside them, timed again with a longer spin
              where the card caught up, and its host time apart); then
              dryrun_multichip over worlds of 1 (NCCL), 2 (mesh 1 x 2) and
              4 (2 x 2), NCCL where the card count reaches the world,
              else gloo with the ranks sharing cuda:0 (the world of 2 also
              codes kennedy.xls at its rcx_params, wlog 0, and its
              rcq_params over lane = 2, and CT-RC2 at its adaptive
              parameters: each container against the oracle's, which
              the oracle workers compute from the start, and the
              single-device one, the mesh decodes against the input);
              then the launch module under torchrun in two processes at
              2^20. Each run's backend, world, mesh, encode and decode
              seconds and a decode exchange's microseconds are printed
              beside the nvidia-smi line. The launches of A, B, C, D, E
              and J inside the sharded calls (not the checks beside
              them) are their `launches_by_path["parallel"]`: a world of
              one must run the one-shot kernels and no form, a world
              with lane = 2 every form in every rank and no one-shot
              A, C, D, E or J, every decode with lane = 2 exchange
              steps - 1 times and no encode exchange at all.
Then a {"kernels": [...]} JSON line (per kernel: launches on the main
paths and main_ms, the largest difference from its plain version, its time and the
plain version's at kennedy.xls's shape, and the bound: the larger of the
bytes it moves over the memory rate and its operations over the peak
rate; `ms_at`, its times at each shape timed, for B `passes_ms` and for
H `wrapper_ms`; A, C, D, E and J `forms`, the new form's numbers
(its largest difference from its plain version, its ms at kennedy.xls
beside the one-shot kernel's); `launches_by_path`, its launches on each
codec's path and on the parallel path;
`tpu_kernel`, the Pallas kernel it replaces, null for J, K, L, M, N, O,
P, Q, R, S, T, U, V, W, X, Y and Z, which replace the JAX package's
lax.scan loops and XLA code), the nvidia-smi line, and last
{"ok": true, "device": {...}}. Each phase prints its seconds.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import pickle
import shutil
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

import cpprcoder_tpu_torch as ctt
from cpprcoder_tpu_torch.bench import lz_edges
from cpprcoder_tpu_torch.bench.synth import synth_stream
from cpprcoder_tpu_torch.codecs import stream
from cpprcoder_tpu_torch.codecs.resume import RCQResumableEncoder
from cpprcoder_tpu_torch.config import adaptive_params_for, pick_lanes
from cpprcoder_tpu_torch.core.bytesutil import ByteReader, CorruptContainerError
from cpprcoder_tpu_torch.models.cxmodel import rcq_params, rcx_params
from cpprcoder_tpu_torch.models.static_table import normalize_freqs
from cpprcoder_tpu_torch.native import build, ctrc
from cpprcoder_tpu_torch.ops import (
    ans2_kernels,
    ans2_ops,
    ase_kernels,
    ase_ops,
    compaction,
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
    rcq_ops,
    rcx_kernels,
    rcx_ops,
)
from cpprcoder_tpu_torch.parallel import dryrun, spawn
from cpprcoder_tpu_torch.reference import (
    ans2_ref,
    ase_ref,
    o1_ref,
    rc_ref,
    rcq_ref,
    rcx_ref,
    slz4_ref,
)
from cpprcoder_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.abspath(__file__))
MASK32 = 0xFFFFFFFF

# Container bytes at each codec's defaults (CT-RCX: the balanced preset),
# from the numpy oracles; a container's bytes do not depend on the device
EXPECTED_SIZES = {
    "rcx": {
        "alice29.txt": 80192, "asyoulik.txt": 65110, "cp.html": 14001,
        "fields.c": 5623, "grammar.lsp": 2015, "kennedy.xls": 449071,
        "lcet10.txt": 232081, "plrabn12.txt": 249999, "ptt5": 70628,
        "sum": 20359, "xargs.1": 2534,
    },
    "rcq": {
        "alice29.txt": 88623, "asyoulik.txt": 76180, "cp.html": 16362,
        "fields.c": 7073, "grammar.lsp": 2304, "kennedy.xls": 450232,
        "lcet10.txt": 252633, "plrabn12.txt": 276850, "ptt5": 77083,
        "sum": 23531, "xargs.1": 2745,
    },
    "rans": {
        "alice29.txt": 87357, "asyoulik.txt": 75583, "cp.html": 16313,
        "fields.c": 7194, "grammar.lsp": 2347, "kennedy.xls": 461571,
        "lcet10.txt": 249921, "plrabn12.txt": 273833, "ptt5": 78748,
        "sum": 25799, "xargs.1": 2782,
    },
    "huffman": {
        "alice29.txt": 88135, "asyoulik.txt": 76095, "cp.html": 16373,
        "fields.c": 7179, "grammar.lsp": 2311, "kennedy.xls": 463937,
        "lcet10.txt": 251325, "plrabn12.txt": 276369, "ptt5": 107311,
        "sum": 25859, "xargs.1": 2745,
    },
    "static_range": {
        "alice29.txt": 87213, "asyoulik.txt": 75516, "cp.html": 16314,
        "fields.c": 7205, "grammar.lsp": 2362, "kennedy.xls": 460981,
        "lcet10.txt": 249621, "plrabn12.txt": 273530, "ptt5": 78467,
        "sum": 25810, "xargs.1": 2793,
    },
    "adaptive_range": {
        "alice29.txt": 87115, "asyoulik.txt": 75413, "cp.html": 16188,
        "fields.c": 6986, "grammar.lsp": 2221, "kennedy.xls": 428581,
        "lcet10.txt": 248323, "plrabn12.txt": 274027, "ptt5": 71426,
        "sum": 22818, "xargs.1": 2658,
    },
    "blocksort": {
        "alice29.txt": 152122, "asyoulik.txt": 125208, "cp.html": 24616,
        "fields.c": 11171, "grammar.lsp": 3738, "kennedy.xls": 1029889,
        "lcet10.txt": 426819, "plrabn12.txt": 481938, "ptt5": 513293,
        "sum": 38261, "xargs.1": 4236,
    },
    "mtf": {
        "alice29.txt": 152094, "asyoulik.txt": 125184, "cp.html": 24608,
        "fields.c": 11155, "grammar.lsp": 3726, "kennedy.xls": 1029749,
        "lcet10.txt": 426759, "plrabn12.txt": 481866, "ptt5": 513221,
        "sum": 38245, "xargs.1": 4232,
    },
    "rle0": {
        "alice29.txt": 152093, "asyoulik.txt": 125183, "cp.html": 24607,
        "fields.c": 11154, "grammar.lsp": 3725, "kennedy.xls": 948314,
        "lcet10.txt": 426758, "plrabn12.txt": 481865, "ptt5": 125733,
        "sum": 32380, "xargs.1": 4231,
    },
    # the default stages: blocksort (2^19-byte blocks), mtf1, rle0,
    # adaptive_range
    "pipeline": {
        "alice29.txt": 45925, "asyoulik.txt": 44969, "cp.html": 8613,
        "fields.c": 3597, "grammar.lsp": 1422, "kennedy.xls": 136984,
        "lcet10.txt": 119107, "plrabn12.txt": 159953, "ptt5": 48569,
        "sum": 14046, "xargs.1": 1803,
    },
}
EXPECTED_SIZES["mtf1"] = EXPECTED_SIZES["mtf"]   # one container size
# CT-ASE1 and CT-RC3 at their defaults (K = pick_lanes(n), inc =
# pick_inc(K)), in the oracles' bytes: 2,436,173 and 1,089,675 in all
EXPECTED_SIZES["ase"] = {
    "alice29.txt": 133011, "asyoulik.txt": 109915, "cp.html": 21707,
    "fields.c": 9865, "grammar.lsp": 3285, "kennedy.xls": 923819,
    "lcet10.txt": 374375, "plrabn12.txt": 421243, "ptt5": 401601,
    "sum": 33615, "xargs.1": 3737,
}
# CT-ANS2 at its defaults (K = pick_lanes(n), inc 8, limit_log2 18,
# refresh_log2 default_refresh_log2(K, n)), in the oracle's bytes:
# 1,297,962 in all
EXPECTED_SIZES["adaptive_rans"] = {
    "alice29.txt": 87700, "asyoulik.txt": 75902, "cp.html": 16308,
    "fields.c": 7148, "grammar.lsp": 2246, "kennedy.xls": 474744,
    "lcet10.txt": 250746, "plrabn12.txt": 275128, "ptt5": 78846,
    "sum": 26496, "xargs.1": 2698,
}
EXPECTED_SIZES["adaptive_o1"] = {
    "alice29.txt": 74057, "asyoulik.txt": 61491, "cp.html": 12706,
    "fields.c": 5246, "grammar.lsp": 1761, "kennedy.xls": 406471,
    "lcet10.txt": 211119, "plrabn12.txt": 230303, "ptt5": 64885,
    "sum": 19421, "xargs.1": 2215,
}
# CT-LZ4 at seg_log2 17, lazy: the v2 parse the card writes (the oracle's
# slz4_encode(parse="v2"); its backend="ref" writes the v1 parse)
EXPECTED_SIZES["slz4"] = {
    "alice29.txt": 71996, "asyoulik.txt": 63239, "cp.html": 11200,
    "fields.c": 4698, "grammar.lsp": 1844, "kennedy.xls": 328159,
    "lcet10.txt": 194547, "plrabn12.txt": 255487, "ptt5": 82237,
    "sum": 17377, "xargs.1": 2505,
}
# the 11 files concatenated at seg_log2 17 (22 segments): past the JAX
# serializer's 2^18-token packing (C1), in the v2 oracle's bytes; and the
# v1 oracle's containers of the 11 files, which the card decodes
SLZ4_CONCAT_BYTES = 1034684
SLZ4_V1_BYTES = 1140737
# the 11 files concatenated in name order (2,810,784 bytes: K = 1,024,
# limit_log2 17, three slots a step), in the oracles' bytes
CONCAT_BYTES = {"static_range": 1658645, "adaptive_range": 1257925}
# fields.c at the widest lane counts J and L take (the oracle's sizes)
RANGE_WIDE_BYTES = {("static_range", 16384): 50193,
                    ("static_range", 32768): 99345,
                    ("static_range", 65536): 197649,
                    ("adaptive_range", 16384): 60309,
                    ("adaptive_range", 32768): 109461,
                    ("adaptive_range", 65536): 207765}
RATIO_FILES = ["alice29.txt", "kennedy.xls", "ptt5"]
# the widest lane count (K * inc <= 49,152): alice29.txt[:40000] at K =
# 32,768, whose containers the oracles write in these bytes
WIDE_K = 32768
WIDE_BYTES = {"rcx": 138314, "rcq": 131317}
# the resumable CT-RCQ encoder's files (K = 2,048 over 503 steps: 8
# chunks; K = 32 over 349: 6)
RESUME_FILES = ["kennedy.xls", "fields.c"]
# CT-SB: every ported codec over the concatenated corpus in superblocks of
# 2^14 bytes; then a large stream (bench/synth.py's mix of text, records,
# runs and random bytes) of 2^30 + 12,345 bytes at the default 2^25 (33
# superblocks, the last 12,345 bytes) over rcx and rans
STREAM_CODECS = sorted(EXPECTED_SIZES)
STREAM_SB_LOG2 = 14
LARGE_N = (1 << 30) + 12_345
LARGE_SB_LOG2 = 25
SYNTH_SEED = 2026
# the stream path's wrapper calls, each a (start, end) pair of CUDA events
# around it, by kernel (phase_main fills it; stream_large reads it)
TIMED_CALLS: dict[str, list] = {}

# each kernel's wrapper module, its launch counter there and the wrapper
# function through which the container paths launch it (phase_main records
# every call of it and times it again)
COUNTERS = {
    "rcx_encode": (rcx_kernels, "encode_launches", "encode_events"),
    "expand": (expand, "launches", "materialize_rows"),
    "rcx_decode": (rcx_kernels, "decode_launches", "decode_symbols"),
    "rcq_encode": (rcq_kernels, "encode_launches", "encode_events"),
    "rcq_encode_chunk": (rcq_kernels, "chunk_launches", "encode_chunk"),
    "rcq_decode": (rcq_kernels, "decode_launches", "decode_symbols"),
    "rans_encode": (rans_kernels, "encode_launches", "encode_events"),
    "rans_decode": (rans_kernels, "decode_launches", "decode_symbols"),
    "huffman_encode": (huffman_kernels, "encode_launches", "encode_stream"),
    "huffman_decode": (huffman_kernels, "decode_launches", "decode_symbols"),
    "rc_exact_encode": (range_kernels, "encode_launches", "encode_events"),
    "rc_exact_decode": (range_kernels, "decode_launches", "decode_symbols"),
    "mtf_encode": (mtf_kernels, "encode_launches", "encode_ranks"),
    "mtf_decode": (mtf_kernels, "decode_launches", "decode_bytes"),
    "lz_match_v2": (lz_kernels, "match_v2_launches", "match_v2"),
    "lz_match_v1": (lz_kernels, "match_launches", "match_v1"),
    "lz_walk": (lz_kernels, "walk_launches", "walk"),
    "lz_serialize": (lz_kernels, "serialize_launches", "serialize"),
    "lz_decode": (lz_kernels, "decode_launches", "decode"),
    "ase_encode": (ase_kernels, "encode_launches", "encode_words"),
    "ase_decode": (ase_kernels, "decode_launches", "decode_symbols"),
    "o1_encode": (o1_kernels, "encode_launches", "encode_events"),
    "o1_decode": (o1_kernels, "decode_launches", "decode_symbols"),
    "ans2_model": (ans2_kernels, "model_launches", "window_tables"),
    "ans2_encode": (ans2_kernels, "encode_launches", "encode_events"),
    "ans2_decode": (ans2_kernels, "decode_launches", "decode_symbols"),
}
# the kernels each codec's main path runs (blocksort and rle0 are tensor
# code: no kernel of their own)
RC_EXACT = ["rc_exact_encode", "expand", "rc_exact_decode"]
MTF = ["mtf_encode", "mtf_decode"]
PATH_KERNELS = {
    "rcx": ["rcx_encode", "expand", "rcx_decode"],
    "rcq": ["rcq_encode", "expand", "rcq_decode"],
    "rans": ["rans_encode", "rans_decode"],
    "huffman": ["huffman_encode", "huffman_decode"],
    "static_range": RC_EXACT, "adaptive_range": RC_EXACT,
    "blocksort": [], "mtf": MTF, "mtf1": MTF, "rle0": [],
    "pipeline": MTF + RC_EXACT,
    "slz4": ["lz_match_v2", "lz_walk", "lz_serialize", "lz_decode"],
    # the v1 parse (an ops-level argument: the codec writes v2 on the card)
    "slz4_v1": ["lz_match_v1", "lz_walk", "lz_serialize", "lz_decode"],
    "ase": ["ase_encode", "ase_decode"],
    "adaptive_o1": ["o1_encode", "expand", "o1_decode"],
    "adaptive_rans": ["ans2_model", "ans2_encode", "ans2_decode"],
    # the resumable CT-RCQ encoder (O, B), one-shot rcq (D) and the
    # decode (E) that it is held to
    "resume": ["rcq_encode_chunk", "expand", "rcq_encode", "rcq_decode"],
}
# CT-SB over every ported codec: every kernel but O and Z (CT-SB's slz4
# writes the v2 parse)
PATH_KERNELS["stream"] = sorted({nm for ks in PATH_KERNELS.values()
                                 for nm in ks} - {"rcq_encode_chunk",
                                                  "lz_match_v1"})

# The bound of a kernel (bound_ms): the larger of the bytes it must move
# (each input read once, each output written once) over the H100's
# 3.35 TB/s and its integer operations over 67 T/s, the card's peak rate
# outside the tensor cores (the float32 rate; no kernel here has work for
# the tensor cores, and no int32 rate is higher). Operations are counted
# from the function each kernel computes, per coded symbol (table reads,
# shifts, compares, multiplies and divides as one each; the decoders'
# symbol search included), per model cell requantized (rescale, quantize,
# argmax and cumsum) and, for B, per event and payload byte.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
OPS_PER_SYMBOL = {"rcx_encode": 24, "rcx_decode": 40, "rcq_encode": 24,
                  "rcq_decode": 40, "rans_encode": 10, "rans_decode": 11,
                  "huffman_encode": 12, "huffman_decode": 40,
                  "rc_exact_encode": 24, "rc_exact_decode": 40,
                  "rcq_encode_chunk": 24, "ase_encode": 8, "ase_decode": 8,
                  "o1_encode": 35, "o1_decode": 50, "ans2_model": 1,
                  "ans2_encode": 10, "ans2_decode": 12}
OPS_PER_CELL = 12      # a model cell's requant
OPS_PER_TABLE_CELL = 5  # CT-RC2's table before a step: sum, halve, scan
OPS_PER_EVENT = 5      # kernel B: an event's fields and its lane cumsum
# M and N: a byte at rank r compares r + 1 entries and moves r of them,
# plus the rank's own bookkeeping: 2r + 4 (counted from this run's ranks)
# S and T: a symbol compares and moves the table's entries, `size` of them
# for a hit or a literal, 63 more for a literal into a full table (counted
# from this run's tables by the plain version), plus 8 for its bits.
# U and V: a symbol's coder and blend (35 to encode, 50 to decode, the
# search included), plus its prefix sums in t1 and t0, (s >> 4) + (s & 15)
# adds each (from this run's bytes); a step checks the 256 rows, and a
# halved row costs OPS_PER_TABLE_CELL a count (this run's halvings)
# W, X and Y: W a histogram add a byte, X and Y their coder steps (Y's with
# the cum2sym read and the refill's offset), and W and Y OPS_PER_ANS2_CELL
# a table cell (this run's windows): the walk's update and rescale, the
# normalize's pre-scale, divide, remainder, a rank from a sort of 256 (8
# compares) and the scan, and Y's cum2sym
OPS_PER_ANS2_CELL = 20
# Z: a position's key, its hash and probe, its rank neighbour's compare,
# the distance and cap rules (the lcp's compares come from the bytes read)
OPS_PER_V1_POSITION = 8
# K: a position's key compares in a sort of its row (2 log2(W): a
# compare and a move each), plus its ladder (11 mixes of 5 operations, 7
# records), its adjacent lcp and six candidates' rules (6 each): 98
OPS_PER_V2_POSITION = 98
# Z's and K's plain versions, ms at each shape timed (phase_kernels_lz
# fills it; the kernels line reports it)
TABLES_MS_AT: dict[str, dict] = {}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def coder_ops(name: str, n: int, requants: int = 0, cells: int = 0) -> int:
    return n * OPS_PER_SYMBOL[name] + requants * cells * OPS_PER_CELL


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def corpus(name: str) -> bytes:
    with open(os.path.join(ROOT, "data", name), "rb") as f:
        return f.read()


def skewed(n: int, seed: int) -> bytes:
    """Bytes whose canonical Huffman code reaches 15 bits (seeded)."""
    rng = np.random.default_rng(seed)
    probs = np.array([2.0 ** -min(i // 16 + 1, 14) for i in range(256)])
    return rng.choice(256, n, p=probs / probs.sum()).astype(np.uint8).tobytes()


def textish(n: int, seed: int) -> bytes:
    """Half lowercase letters, half random bytes (seeded)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(97, 123, n // 2, dtype=np.uint8)
    b = rng.integers(0, 256, n - n // 2, dtype=np.uint8)
    return np.concatenate([a, b]).tobytes()


def runs_and_text(n: int) -> bytes:
    """Alternate 4 KB blocks of kennedy.xls (runs of 0x00 and 0xFF,
    repeated records) and alice29.txt (text), n bytes."""
    a, b = corpus("kennedy.xls"), corpus("alice29.txt")
    out = bytearray()
    i = 0
    while len(out) < n:
        src = a if (i & 1) == 0 else b
        at = (i // 2 * 4096) % (len(src) - 4096)
        out += src[at:at + 4096]
        i += 1
    return bytes(out[:n])


def wide_data() -> bytes:
    return corpus("alice29.txt")[:40000]


def wide_round_trip(codec: str) -> str:
    """compress/decompress(codec, lanes=WIDE_K) on the card: the oracle's
    container, and the input back."""
    data = wide_data()
    blob = ctt.compress(data, codec=codec, device="cuda", lanes=WIDE_K)
    if len(blob) != WIDE_BYTES[codec] or blob != ctt.compress(
            data, codec=codec, backend="ref", lanes=WIDE_K):
        fail(f"{codec} at {WIDE_K} lanes: {len(blob)} bytes, not the "
             f"oracle's {WIDE_BYTES[codec]}")
    if ctt.decompress(blob, codec=codec, device="cuda") != data:
        fail(f"{codec} at {WIDE_K} lanes did not round-trip")
    return f"{codec} at {WIDE_K} lanes round-trips in {len(blob)} bytes"


def rand_events(e: int, k: int, seed: int, run_max: int = 5) -> np.ndarray:
    """Random packed u32 event grid [e, k] as int32 bits."""
    rng = np.random.default_rng(seed)
    emit = rng.random((e, k)) < 0.5
    first = rng.integers(0, 256, (e, k), dtype=np.uint32)
    carry = rng.integers(0, 2, (e, k), dtype=np.uint32)
    run = rng.integers(0, run_max + 1, (e, k), dtype=np.uint32)
    ev = (np.uint32(1) << 31) | (first << 23) | (carry << 22) | run
    return np.where(emit, ev, 0).astype(np.uint32).view(np.int32)


EV_EMIT = 1 << 31


def expand_edge_grids():
    """(events [E, K] int32 bits, may_drop, l2 or None) where kernel B's
    write pass has its edges (a warp scans 32 time steps at a time, tiles
    of 64, a warp's long-run path above 32 bytes, 16 lanes a block): one
    lane holding a single
    run of 2^22 - 1 bytes; long and short runs on both sides of a tile
    boundary; lanes whose first emit falls in a later tile, under a
    may_drop mask; K = 100 and K = 32,768; a given l2 above the largest
    lane (not a multiple of 4)."""
    one = np.zeros((3, 1), np.uint32)
    one[1, 0] = EV_EMIT | (0x5A << 23) | ((1 << 22) - 1)
    edge = rand_events(96, 40, 20, run_max=3).view(np.uint32).copy()
    rng = np.random.default_rng(21)
    for e in (31, 32, 63, 64):
        edge[e] = EV_EMIT | (rng.integers(0, 512, 40, dtype=np.uint32) << 22) \
            | rng.integers(0, 200, 40, dtype=np.uint32)
    late = rand_events(150, 64, 22).view(np.uint32).copy()
    for i in range(64):
        late[:32 * (i % 4) + i % 7, i] = 0
    md = np.zeros(64, bool)
    md[::2] = True
    given = rand_events(70, 50, 24, run_max=9)
    _, sizes = compaction.materialize_rows_t(torch.from_numpy(given))
    return [(one.view(np.int32), True, None), (edge.view(np.int32), True, None),
            (late.view(np.int32), md, None),
            (rand_events(300, 100, 25, run_max=40), True, None),
            (rand_events(40, 32768, 26), True, None),
            (given, False, int(sizes.max()) + 37)]


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| of two integer tensors, int32 read as u32."""
    a, b = a.to(torch.int64), b.to(torch.int64)
    if a.numel() == 0:
        return 0
    return int(((a & MASK32) - (b & MASK32)).abs().max())


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def median_call_ms(fn, calls: int = 50) -> float:
    """Median device ms of one call of fn, each call timed apart with CUDA
    events after a warm-up: for a call that waits on the host inside (kernel
    B's wrapper), whose time the host's noise spreads."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ts = []
    for _ in range(calls):
        start.record()
        fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    return float(np.median(ts))


def run_ms(fn):
    """fn() once, timed with CUDA events: -> (its output, ms)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def queued_ms(fn, reps: int = 20) -> float:
    """Device ms a call of fn, its launches' host time hidden: the calls are
    queued behind a spin of the stream (about 2.5 ms), so the card runs
    them back to back."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(5_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_env():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    name = torch.cuda.get_device_name(0)
    nvcc = build.nvcc_path()
    nvcc_ver = "missing"
    if nvcc:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True).stdout.strip().splitlines()
        nvcc_ver = out[-1] if out else "?"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"[env] ok device={name!r} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda} "
          f"nvcc={nvcc_ver!r} smi={smi_line!r}", flush=True)
    return name, smi_line


def phase_build():
    t0 = time.perf_counter()
    path = build.build()
    build.load()
    dt = time.perf_counter() - t0
    log = (path.parent / "nvcc.log").read_text()
    usage = [ln.split("ptxas info    :")[-1].strip() for ln in log.splitlines()
             if "Used" in ln or "Compiling entry" in ln]
    print(f"[build] ok {os.path.relpath(path, ROOT)} in {dt:.2f} s; "
          f"ptxas: {' | '.join(usage)}", flush=True)


def to_dev(data: bytes, dev) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(dev)


def interleaved_inputs(data: bytes, k: int, dev):
    """(n, stride, x2d, lane lengths) of the interleaved lane layout."""
    n = len(data)
    stride = -(-n // k)
    x = to_dev(data, dev)
    return (n, stride, layout.pad2d_interleaved(x, k, stride),
            layout.lane_lengths_interleaved(n, k, stride, dev))


def hold(err: dict, name: str, out_k, out_p, what: str):
    """Hold a kernel's output (a tensor or a tuple of them) against its
    plain version's: exact equality, the largest difference into
    err[name]. -> the kernel's output."""
    torch.cuda.synchronize()
    ks = out_k if isinstance(out_k, tuple) else (out_k,)
    ps = out_p if isinstance(out_p, tuple) else (out_p,)
    err[name] = max([err[name]] + [max_err(a, b) for a, b in zip(ks, ps)])
    if not all(torch.equal(a, b) for a, b in zip(ks, ps)):
        fail(f"{what} != plain")
    return out_k


def lane_cases(seed: int):
    """(K, data) for the thread-per-lane kernels: K in {1, 2, 64, 256,
    8192}, n ragged (not a multiple of K) but at K = 1, and a single-symbol
    run."""
    return [(1, textish(2000, seed)), (2, textish(3721, seed + 1)),
            (64, textish(64 * 500 + 17, seed + 2)),
            (256, textish(256 * 300 + 5, seed + 3)),
            (8192, textish(8192 * 40 + 3, seed + 4)), (64, b"\x42" * 2001)]


def time_at(files, case, args, plain_reps: int, what: str, timers=None,
            plain_done=None):
    """Hold `case` at each file's main-path shape (args(n) gives its
    parameters) and time its kernels, 5 reps after a warm-up (or by
    timers[kernel](call), where given); the plain versions only at the
    first file, `plain_reps` reps, or the one run the case timed while it
    held the kernel (plain_done[kernel], where the case fills it). Prints
    the line `[kernels] ok {what}; ...`. -> ({kernel: (ms, plain ms)},
    {kernel: (bytes, ops)}) at the first file, {kernel: {file: ms}} at
    both."""
    at, ms, work = {}, {}, {}
    timers = timers or {}
    plain_done = {} if plain_done is None else plain_done
    for i, name in enumerate(files):
        data = corpus(name)
        plain_done.clear()
        shape, fns, w = case(data, *args(len(data)), name)
        at[name] = f"{name} ({shape})"
        ms[name] = {nm: (timers.get(nm, lambda f: cuda_ms(f, 5))(kern),
                         i == 0 and (plain_done.get(nm)
                                     or cuda_ms(plain, plain_reps, 0)))
                    for nm, (kern, plain) in fns.items()}
        work = work or w
    big, small = files
    print(f"[kernels] ok {what}; at {at[big]} ms kernel/plain: "
          + ", ".join(f"{nm} {a:.3f}/{b:.3f}" for nm, (a, b) in ms[big].items())
          + f"; at {at[small]} ms kernel: "
          + ", ".join(f"{nm} {a:.3f}" for nm, (a, _) in ms[small].items()),
          flush=True)
    at_ms = {nm: {f: ms[f][nm][0] for f in files} for nm in ms[big]}
    return ms[big], work, at_ms


def coder_inputs(data: bytes, k: int, dev):
    """(n, stride, x2d, lane lengths) of the chunked lane layout."""
    n = len(data)
    stride = -(-n // k)
    x = to_dev(data, dev)
    return (n, stride, layout.pad2d_chunked(x, k, stride),
            layout.lane_lengths(n, k, stride, dev))


def coder_cases():
    """(K, cbits, wlog, data, inc, climit) for A and C; inc and climit None
    take rcx_params'. K from 32 to 32,768 (100 and 1500 are not multiples
    of 32; from 1024 on, A and C run a 4-block cluster a stream, 1 to 8
    lanes a thread),
    cbits 0 to 8 (8: the model in global scratch, one block), wlog 0 to 3;
    a one-byte run (every lane on one cell; in the cluster, halvings that
    bring a row back to its total of the window before), kennedy.xls's
    runs mixed with text, and a row that halves at nearly every window
    (large inc, small climit: rows stay at or above climit and are
    redone)."""
    t = textish
    return [(32, 6, 2, t(3000, 100), None, None),
            (32, 8, 0, t(2500, 101), None, None),
            (1024, 5, 0, t(150_000, 102), None, None),
            (1024, 8, 2, t(60_000, 103), None, None),
            (2048, 4, 2, t(1_029_744, 104), None, None),
            (2048, 6, 0, t(200_000, 105), None, None),
            (2048, 8, 2, t(300_000, 106), None, None),
            (64, 6, 2, b"\x00" * 20_000, None, None),
            (2048, 4, 2, runs_and_text(400_000), None, None),
            (100, 6, 1, t(100 * 97 + 13, 107), None, None),
            (1500, 5, 2, t(1500 * 61, 108), None, None),
            (1024, 0, 3, t(1024 * 40 + 3, 112), None, None),
            (96, 0, 1, t(96 * 50 + 5, 113), None, None),
            (1024, 4, 2, b"\x00" * 61_440, None, None),
            (4096, 4, 2, t(4096 * 50 + 1, 109), None, None),
            (8192, 7, 2, t(8192 * 30 + 7, 110), None, None),
            (256, 6, 3, t(256 * 300, 111), 255, 1 << 10),
            (16384, 6, 2, wide_data(), None, None),
            (32768, 6, 2, wide_data(), None, None)]


def phase_kernels(dev):
    err = {"rcx_encode": 0, "expand": 0, "rcx_decode": 0}

    def case(data, k, inc, climit, cbits, wlog, what):
        """Hold A and C against their plain versions on `data`; -> (shape,
        {kernel: (kernel call, plain call)}, {kernel: (bytes, ops)})."""
        n, stride, x2d, lens = coder_inputs(data, k, dev)
        args = (inc, climit, cbits, wlog)
        enc = (lambda: rcx_kernels.encode_events(x2d, lens, *args),
               lambda: rcx_ops.encode_events_plain(x2d, lens, *args))
        ev = hold(err, "rcx_encode", enc[0](), enc[1](), f"kernel A at {what}")
        words = layout.decode_words(*expand.materialize_rows(ev))
        dec = (lambda: rcx_kernels.decode_symbols(words, lens, n, stride,
                                                  *args),
               lambda: rcx_ops.decode_symbols_plain(words, lens, n, stride,
                                                    *args))
        sym = hold(err, "rcx_decode", dec[0](), dec[1](), f"kernel C at {what}")
        if sym.cpu().numpy().tobytes() != data:
            fail(f"kernel C did not invert kernel A at {what}")
        requants, cells = -(-stride // (1 << wlog)), (1 << cbits) * 256
        work = {"rcx_encode": (nbytes(x2d, lens, ev),
                               coder_ops("rcx_encode", n, requants, cells)),
                "rcx_decode": (nbytes(words, lens) + n,
                               coder_ops("rcx_decode", n, requants, cells))}
        return (f"K={k}, stride={stride}, cbits={cbits}, wlog={wlog}",
                {"rcx_encode": enc, "rcx_decode": dec}, work, ev)

    cases = coder_cases()
    for k, cbits, wlog, data, inc, climit in cases:
        _, inc0, cl, _ = rcx_params(len(data), lanes=k, cbits=cbits)
        inc = inc0 if inc is None else inc
        climit = 1 << cl if climit is None else climit
        *_, ev_p = case(data, k, inc, climit, cbits, wlog,
                        f"K={k} cbits={cbits} wlog={wlog} n={len(data)} "
                        f"inc={inc} climit={climit}")

    # B: random grids (non-aligned E/K, a may_drop mask, an empty lane),
    # the real event grid of the last coder case, and the write pass's
    # edges
    grids = [(rand_events(18, 8, 0), True, None),
             (rand_events(257, 200, 1), True, None),
             (rand_events(1008, 2048, 2, run_max=40), True, None)]
    masked = rand_events(130, 96, 3)
    masked[:, 5] = 0
    md = np.zeros(96, bool)
    md[::3] = True
    grids += [(masked, md, None), (ev_p.cpu().numpy(), True, None)]
    grids += expand_edge_grids()
    for ev_np, may_drop, l2 in grids:
        ev = torch.from_numpy(np.ascontiguousarray(ev_np)).to(dev)
        md_t = may_drop if isinstance(may_drop, bool) else \
            torch.from_numpy(may_drop).to(dev)
        rows_k, sizes_k = expand.materialize_rows(ev, l2, may_drop=md_t)
        rows_p, sizes_p = compaction.materialize_rows_t(ev, rows_k.shape[1],
                                                        md_t)
        torch.cuda.synchronize()
        err["expand"] = max(err["expand"], max_err(rows_k, rows_p),
                            max_err(sizes_k, sizes_p))
        if not (torch.equal(rows_k, rows_p) and torch.equal(sizes_k, sizes_p)):
            fail(f"kernel B != plain on a {tuple(ev.shape)} grid")
        if l2 is not None and rows_k.shape[1] != l2:
            fail(f"kernel B took l2={rows_k.shape[1]}, not the given {l2}")

    # A, B and C held and timed at kennedy.xls's shape (balanced preset),
    # kernel vs plain; A and C also at grammar.lsp's (K = 32, cbits 6) and
    # at alice29.txt's under the ratio preset (K = 256, cbits 6, wlog 0),
    # kernels alone
    ms, ms_at, work = {}, {"rcx_encode": {}, "rcx_decode": {}}, {}
    notes, b_grids = [], {}
    for name, mode, wlog in (("kennedy.xls", "balanced", 2),
                             ("grammar.lsp", "balanced", 2),
                             ("alice29.txt", "ratio", 0)):
        data = corpus(name)
        k, inc, cl, cbits = rcx_params(len(data), mode=mode)
        shape, fns, w, ev = case(data, k, inc, 1 << cl, cbits, wlog,
                                 f"{name} ({mode})")
        at = name if mode == "balanced" else f"{name} ratio"
        if mode == "balanced":
            b_grids[f"{name} (rcx)"] = ev
        big = not ms
        if big:     # B's time there is its wrapper's, from expand_times
            rows, sizes = expand.materialize_rows(ev)
            l2 = rows.shape[1]
            b_plain = cuda_ms(lambda: compaction.materialize_rows_t(ev, l2), 2)
            w["expand"] = (nbytes(ev, rows, sizes),
                           ev.numel() * OPS_PER_EVENT + int(sizes.sum()))
            work = w
        for nm, (kern, plain) in fns.items():
            t = (cuda_ms(kern, 5), big and cuda_ms(plain, 2))
            if big:
                ms[nm] = t
            if nm in ms_at:
                ms_at[nm][at] = t[0]
        notes.append(f"{at} ({shape})")
    data = corpus("fields.c")
    k, inc, cl = rcq_params(len(data))
    _, _, x2d, lens = interleaved_inputs(data, k, dev)
    b_grids["fields.c (rcq)"] = rcq_kernels.encode_events(x2d, lens, inc,
                                                          1 << cl)
    ms_at["expand"], passes = expand_times(b_grids)
    ms["expand"] = (ms_at["expand"]["kennedy.xls (rcx)"], b_plain)
    print(f"[kernels] ok {len(cases) + 3} coder cases (A, C) and {len(grids)} "
          f"event grids (B) equal their plain versions; "
          f"{wide_round_trip('rcx')}; at {notes[0]} ms "
          f"kernel/plain: "
          + ", ".join(f"{nm} {a:.3f}/{b:.3f}" for nm, (a, b) in ms.items())
          + "; ms kernel A / C at " + ", ".join(
              f"{nm}: {ms_at['rcx_encode'][nm]:.3f} / "
              f"{ms_at['rcx_decode'][nm]:.3f}" for nm in ms_at["rcx_encode"])
          + f" ({'; '.join(notes[1:])}); ms B through its wrapper / sizes "
          f"pass / rows pass / host round trip at " + ", ".join(
              f"{nm}: {ms_at['expand'][nm]:.4f} / {p['sizes']:.4f} / "
              f"{p['rows']:.4f} / {p['sync']:.4f}"
              for nm, p in passes.items()), flush=True)
    return err, ms, work, ms_at, passes


def expand_times(grids: dict):
    """Kernel B at each event grid (may_drop True, as the containers call
    it): ms through its wrapper (`median_call_ms`, the host round trip
    inside each call), and apart: the sizes pass and the rows pass (device
    time, `queued_ms`) and the host round trip that reads the largest size
    back (host clock, the median of 20 on an idle stream).
    -> ({grid: wrapper ms}, {grid: {"sizes", "rows", "sync": ms}})."""
    at, passes = {}, {}
    for name, ev in grids.items():
        md, drop_all = expand.drop_mask(True, ev.shape[1], ev.device)
        _, top = expand.count_sizes(ev, md, drop_all)
        l2 = compaction.row_width(int(top))
        at[name] = median_call_ms(lambda: expand.materialize_rows(ev))
        trips = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            int(top)
            trips.append(time.perf_counter() - t0)
        passes[name] = {
            "sizes": queued_ms(lambda: expand.count_sizes(ev, md, drop_all)),
            "rows": queued_ms(lambda: expand.write_rows(ev, md, drop_all, l2)),
            "sync": float(np.median(trips)) * 1e3}
    return at, passes


def phase_kernels_rcq(dev):
    """D and E against kernels A's and C's plain step loops with one
    context, a requant every step and one halving (rounds=1)."""
    err = {"rcq_encode": 0, "rcq_decode": 0}

    def case(data, k, inc, cl, what):
        """Hold D and E against their plain versions on `data`; -> (shape,
        {kernel: (kernel call, plain call)}, {kernel: (bytes, ops)})."""
        n, stride, x2d, lens = interleaved_inputs(data, k, dev)
        enc = (lambda: rcq_kernels.encode_events(x2d, lens, inc, 1 << cl),
               lambda: rcx_ops.encode_events_plain(x2d, lens, inc, 1 << cl,
                                                   0, 0, 1))
        ev = hold(err, "rcq_encode", enc[0](), enc[1](), f"kernel D at {what}")
        words = layout.decode_words(*expand.materialize_rows(ev))
        dec = (lambda: rcq_kernels.decode_symbols(words, lens, n, stride, inc,
                                                  1 << cl),
               lambda: rcx_ops.decode_symbols_plain(
                   words, lens, n, stride, inc, 1 << cl, 0, 0, 1,
                   interleaved=True))
        sym = hold(err, "rcq_decode", dec[0](), dec[1](), f"kernel E at {what}")
        if sym.cpu().numpy().tobytes() != data:
            fail(f"kernel E did not invert kernel D at {what}")
        work = {"rcq_encode": (nbytes(x2d, lens, ev),
                               coder_ops("rcq_encode", n, stride, 256)),
                "rcq_decode": (nbytes(words, lens) + n,
                               coder_ops("rcq_decode", n, stride, 256))}
        return f"K={k}, stride={stride}", {"rcq_encode": enc,
                                           "rcq_decode": dec}, work

    # K in {32, 100, 128, 1024, 2048, 4096, 8192} at rcq_params' defaults
    # (100 not a multiple of 32; 4096 and 8192 two to eight lanes a
    # thread), a one-byte run (every lane on one cell), kennedy.xls's runs
    # mixed with text, the single-halving case, which halves at nearly
    # every step (K*inc > climit; the oracle asserts there), and 16 and 32
    # lanes a thread
    cases = [(32, textish(3000, 200), None, None),
             (128, textish(40_000, 201), None, None),
             (1024, textish(300_000, 202), None, None),
             (2048, textish(600_001, 203), None, None),
             (100, textish(100 * 70 + 3, 204), None, None),
             (4096, textish(4096 * 40 + 9, 205), None, None),
             (8192, textish(8192 * 20 + 5, 206), None, None),
             (64, b"\x00" * 20_000, None, None),
             (2048, runs_and_text(400_000), None, None),
             (128, textish(4096, 207), 24, 10),
             (16384, wide_data(), None, None),
             (32768, wide_data(), None, None)]
    for k, data, inc, cl in cases:
        _, inc0, cl0 = rcq_params(len(data), lanes=k)
        inc = inc0 if inc is None else inc
        cl = cl0 if cl is None else cl
        case(data, k, inc, cl, f"K={k} n={len(data)} inc={inc} cl={cl}")

    # held and timed at kennedy.xls's CT-RCQ shape, kernel vs plain; held
    # there and at fields.c's (K = 32, one warp), where the per-step requant
    # sets the pace and the kernels alone are timed
    ms, work, ms_at = time_at(("kennedy.xls", "fields.c"), case, rcq_params,
                              2, f"{len(cases) + 2} CT-RCQ cases (D, E) equal "
                              f"their plain versions; {wide_round_trip('rcq')}")
    return err, ms, work, ms_at


def chunk_start(k: int, pending: bool, seed: int, dev):
    """(state [5, K] int32, C [256] int32) for kernel O: the fresh
    encoder's, or a saved state whose lanes hold pending runs (low at
    0xFF......, cache_size up to 4,000, carry on some lanes) and a model
    with a history (seeded)."""
    if pending:
        rng = np.random.default_rng(seed)

        def u32(lo, hi):
            return rng.integers(lo, hi, k, dtype=np.uint64)
        st = np.stack([u32(0xFF000000, 1 << 32), u32(0, 2),
                       u32(1 << 24, 1 << 32), u32(0, 256), u32(1, 4000)])
        C = rng.integers(1, 60, 256)
    else:
        st = np.stack([np.full(k, v) for v in (0, 0, MASK32, 0, 1)])
        C = np.ones(256)
    return tuple(torch.from_numpy(a.astype(np.uint32).view(np.int32)).to(dev)
                 for a in (st, C))


def phase_kernels_chunk(dev):
    """O (D from a saved state, the flush when asked) against its plain
    version (rcq_ops.encode_chunk_plain), three chunks then a flush-only
    launch a case; timed at kennedy.xls's CT-RCQ shape (K = 2,048, 64-step
    chunks: 7 of 64 steps, then 55 and the flush) beside D's one-shot time
    there and at fields.c's (K = 32, 349 steps)."""
    err = {"rcq_encode_chunk": 0}

    def run(x2d, lens, st, C, inc, climit, steps, what, plain=True,
            flush_alone=True):
        """x2d's rows in chunks of `steps` through O (and its plain
        version), the flush with the last chunk or in a launch of its own
        (no rows); -> the events of every launch."""
        pst, pC = st, C
        evs = []
        starts = list(range(0, x2d.shape[0], steps))
        for t0 in starts + ([x2d.shape[0]] if flush_alone else []):
            rows = x2d[t0:t0 + steps].contiguous()
            flush = t0 == (x2d.shape[0] if flush_alone else starts[-1])
            ev, st, C = rcq_kernels.encode_chunk(rows, lens, t0, st, C, inc,
                                                 climit, flush)
            if plain:
                hold(err, "rcq_encode_chunk", (ev, st, C),
                     rcq_ops.encode_chunk_plain(rows, lens, t0, pst, pC, inc,
                                                climit, flush),
                     f"kernel O at {what}, step {t0}")
                pst, pC = st, C
            evs.append(ev)
        return evs

    # chunks of 1, 63, 64 and 65 steps; K = 1, 100 (not a multiple of 32),
    # 8,192 (8 lanes a thread: PACK) and 32,768 (32); zeros, whose lanes
    # first emit chunks later; 0xFF-heavy input from a state with pending
    # runs (a run crossing chunk edges); n not a multiple of a chunk
    cases = [(1, 1, "text", False), (64, 63, "text", False),
             (256, 64, "zeros", False), (100, 65, "text", True),
             (8192, 64, "ff", True), (32768, 1, "text", False),
             (32768, 65, "zeros", True), (2048, 64, "ff", True)]
    for k, steps, kind, pending in cases:
        n = 3 * steps * k - k // 2 - 1 if k > 1 else 3 * steps
        data = {"text": textish(n, k), "zeros": bytes(n),
                "ff": bytes(np.where(np.arange(n) % 7 < 5, 0xFF, np.frombuffer(
                    textish(n, k + 5), np.uint8)).astype(np.uint8))}[kind]
        _, inc, cl = rcq_params(n, lanes=k)
        _, _, x2d, lens = interleaved_inputs(data, k, dev)
        run(x2d, lens, *chunk_start(k, pending, k, dev), inc, 1 << cl, steps,
            f"K={k} chunk={steps} {kind} pending={pending}")

    # kennedy.xls as the resumable encoder runs it: O's 8 launches held
    # against the plain version, their events against D's one-shot grid;
    # one 64-step chunk timed (ms, plain ms), the 8 launches and D timed
    data = corpus("kennedy.xls")
    k, inc, cl = rcq_params(len(data))
    n, stride, x2d, lens = interleaved_inputs(data, k, dev)
    fresh = chunk_start(k, False, 0, dev)
    evs = run(x2d, lens, *fresh, inc, 1 << cl, 64, "kennedy.xls",
              flush_alone=False)
    d_ev = rcq_kernels.encode_events(x2d, lens, inc, 1 << cl)
    if not torch.equal(torch.cat(evs), d_ev):
        fail("kernel O's chunks at kennedy.xls do not join to kernel D's "
             "events")
    rows = x2d[:64].contiguous()
    one = (lambda: rcq_kernels.encode_chunk(rows, lens, 0, *fresh, inc,
                                            1 << cl),
           lambda: rcq_ops.encode_chunk_plain(rows, lens, 0, *fresh, inc,
                                              1 << cl, False))
    ms = {"rcq_encode_chunk": (cuda_ms(one[0], 5), cuda_ms(one[1], 2))}
    chunked = f"kennedy.xls in {len(evs)} launches (K={k}, 64-step chunks)"
    ms_at = {"kennedy.xls one 64-step chunk": ms["rcq_encode_chunk"][0],
             chunked: cuda_ms(lambda: run(x2d, lens, *fresh, inc, 1 << cl, 64,
                                          "", False, False), 5),
             f"kennedy.xls kernel D one-shot ({stride} steps)": cuda_ms(
                 lambda: rcq_kernels.encode_events(x2d, lens, inc, 1 << cl), 5)}
    small = corpus("fields.c")
    ks, incs, cls = rcq_params(len(small))
    _, strides, x2ds, lenss = interleaved_inputs(small, ks, dev)
    fresh_s = chunk_start(ks, False, 0, dev)
    ms_at[f"fields.c in {-(-strides // 64)} launches (K={ks})"] = cuda_ms(
        lambda: run(x2ds, lenss, *fresh_s, incs, 1 << cls, 64, "", False,
                    False), 5)
    ms_at[f"fields.c kernel D one-shot ({strides} steps)"] = cuda_ms(
        lambda: rcq_kernels.encode_events(x2ds, lenss, incs, 1 << cls), 5)
    # one 64-step chunk moves its rows in, the lane lengths, the state in
    # and out, C in and out and its events out; every lane is active
    ev = one[0]()[0]
    work = {"rcq_encode_chunk": (nbytes(rows, lens) + 2 * nbytes(*fresh)
                                 + nbytes(ev),
                                 coder_ops("rcq_encode_chunk", rows.numel(),
                                           64, 256))}
    print(f"[kernels] ok {len(cases) + 1} kernel O cases (3 chunks then a "
          f"flush-only launch each; kennedy.xls's 8 launches join to D's "
          f"events) equal the plain version; ms kernel/plain at one 64-step "
          f"chunk of kennedy.xls (K={k}): {ms['rcq_encode_chunk'][0]:.4f}/"
          f"{ms['rcq_encode_chunk'][1]:.3f}; ms at " + ", ".join(
              f"{nm} {t:.4f}" for nm, t in ms_at.items()), flush=True)
    return err, ms, work, {"rcq_encode_chunk": ms_at}


def phase_kernels_rans(dev):
    """F and G against their plain step loops."""
    err = {"rans_encode": 0, "rans_decode": 0}

    def case(data, k, what):
        """Hold F and G against their plain versions on `data`; -> (shape,
        {kernel: (kernel call, plain call)}, {kernel: (bytes, ops)})."""
        n, stride, x2d, lens = interleaved_inputs(data, k, dev)
        tables = rans_ops.tables(rans_ops.static_freqs(x2d.reshape(-1)[:n]),
                                 dev)
        enc = (lambda: rans_kernels.encode_events(x2d, lens, *tables),
               lambda: rans_ops.encode_events_plain(x2d, lens, *tables))
        ev, st = hold(err, "rans_encode", enc[0](), enc[1](),
                      f"kernel F at {what}")
        rows = rans_ops.word_rows(*rans_ops.lane_words(ev))
        dec = (lambda: rans_kernels.decode_symbols(st, rows, lens, *tables, n,
                                                   stride),
               lambda: rans_ops.decode_symbols_plain(st, rows, lens, *tables,
                                                     n, stride))
        sym = hold(err, "rans_decode", dec[0](), dec[1](),
                   f"kernel G at {what}")
        if sym.cpu().numpy().tobytes() != data:
            fail(f"kernel G did not invert kernel F at {what}")
        work = {"rans_encode": (nbytes(x2d, lens, *tables, ev, st),
                                coder_ops("rans_encode", n)),
                "rans_decode": (nbytes(st, rows, lens, *tables) + n,
                                coder_ops("rans_decode", n))}
        return f"K={k}, stride={stride}", {"rans_encode": enc,
                                           "rans_decode": dec}, work

    # lane_cases, alice29.txt at its main-path shape (K = 64 over 2,377
    # steps) and the single-symbol lane at K = 48 (a partial warp): the
    # table gives it f = 16,383 and another symbol 1
    cases = lane_cases(300) + [(64, corpus("alice29.txt")),
                               (48, b"\x42" * (48 * 40 + 7))]
    for k, data in cases:
        case(data, k, f"K={k} n={len(data)}")
    full_table_case(dev, err)

    # one lane over 200,000 random bytes (the main path's lanes=1 lane:
    # more than 65,535 words), held against the plain versions on the host
    # (200,000 steps of the plain loops on the card take minutes), then
    # the kernels alone timed
    lane1 = rans_lane1_case(dev, err)

    # held and timed at kennedy.xls's rANS shape, kernel vs plain; held
    # there and at grammar.lsp's (K = 2 lanes over 1,861 steps), where the
    # kernels alone are timed
    ms, work, ms_at = time_at(("kennedy.xls", "grammar.lsp"), case,
                              lambda n: (rans_ops.pick_lanes(n),), 2,
                              f"{len(cases) + 4} rANS cases (F, G) equal "
                              f"their plain versions, one with a table "
                              f"entry of f = 2^14; at 200,000 bytes "
                              f"lanes=1 ms kernel F {lane1['rans_encode']:.3f},"
                              f" G {lane1['rans_decode']:.3f}")
    for nm, t in lane1.items():
        ms_at[nm]["200,000 random bytes lanes=1"] = t
    return err, ms, work, ms_at


def full_table_case(dev, err):
    """G against its plain version under a table where one symbol owns all
    2^14 slots (f = 2^14 needs the entry's 15 bits): random states and word
    rows, K = 100, lane lengths ragged."""
    rng = np.random.default_rng(310)
    freqs = np.zeros(256, np.int64)
    freqs[0x77] = 1 << 14
    tables = rans_ops.tables(freqs, dev)
    k, stride, l2 = 100, 60, 8
    st = torch.from_numpy(rng.integers(1 << 16, 1 << 32, k, dtype=np.uint64)
                          .astype(np.uint32).view(np.int32)).to(dev)
    rows = torch.from_numpy(rng.integers(0, 1 << 16, (l2, k),
                                         dtype=np.int32)).to(dev)
    lens = torch.from_numpy(rng.integers(0, stride + 1, k,
                                         dtype=np.int32)).to(dev)
    active = torch.arange(stride, device=dev)[:, None] < lens[None, :]
    pick = (lambda out: out.view(stride, k)[active])
    sym = hold(err, "rans_decode",
               pick(rans_kernels.decode_symbols(st, rows, lens, *tables,
                                                k * stride, stride)),
               pick(rans_ops.decode_symbols_plain(st, rows, lens, *tables,
                                                  k * stride, stride)),
               "kernel G under a table with f = 2^14")
    if not bool((sym == 0x77).all()):
        fail("kernel G under a table with f = 2^14 decoded another symbol")


def rans_lane1_case(dev, err):
    """F and G at K = 1 over 200,000 random bytes, held against their
    plain versions run on the host; -> {kernel: ms} (3 reps after a
    warm-up)."""
    data = np.random.default_rng(7).integers(0, 256, 200_000,
                                             np.uint8).tobytes()
    n, stride, x2d, lens = interleaved_inputs(data, 1, dev)
    tables = rans_ops.tables(rans_ops.static_freqs(x2d.reshape(-1)), dev)
    host = [t.cpu() for t in (x2d, lens, *tables)]
    ev, st = rans_kernels.encode_events(x2d, lens, *tables)
    hold(err, "rans_encode", (ev.cpu(), st.cpu()),
         rans_ops.encode_events_plain(*host), "kernel F at K=1 n=200,000")
    rows = rans_ops.word_rows(*rans_ops.lane_words(ev))
    if rows.shape[0] <= 0x10000:
        fail(f"K=1 n=200,000 gave {rows.shape[0] - 1} words, not above 65,535")
    sym = rans_kernels.decode_symbols(st, rows, lens, *tables, n, stride)
    hold(err, "rans_decode", sym.cpu(), rans_ops.decode_symbols_plain(
        st.cpu(), rows.cpu(), host[1], *host[2:], n, stride),
        "kernel G at K=1 n=200,000")
    if sym.cpu().numpy().tobytes() != data:
        fail("kernel G did not invert kernel F at K=1 n=200,000")
    return {"rans_encode": cuda_ms(
                lambda: rans_kernels.encode_events(x2d, lens, *tables), 3),
            "rans_decode": cuda_ms(
                lambda: rans_kernels.decode_symbols(st, rows, lens, *tables,
                                                    n, stride), 3)}


def phase_kernels_huffman(dev):
    """H and I against their plain versions; I also on random word rows
    against an incomplete code, where some windows match no code; H at
    lanes=1 on 200,000 random bytes against the oracle's container. H's
    time is its wrapper's device time with its launches queued (`queued_ms`:
    its three passes), and apart, through its wrapper (the median of 50
    calls, its host enqueue inside).
    -> (err, ms, work, ms_at, {shape: H's wrapper ms})."""
    err = {"huffman_encode": 0, "huffman_decode": 0}

    def case(data, k, what):
        """Hold H and I against their plain versions on `data`; -> (shape,
        {kernel: (kernel call, plain call)}, {kernel: (bytes, ops)})."""
        n, stride, x2d, lens = interleaved_inputs(data, k, dev)
        lengths, tab = huffman_ops.encoder_table(x2d.reshape(-1)[:n])
        enc = (lambda: huffman_kernels.encode_stream(x2d, lens, tab),
               lambda: huffman_ops.encode_stream_plain(x2d, lens, tab))
        payload, counts, bits = hold(err, "huffman_encode", enc[0](),
                                     enc[1](), f"kernel H at {what}")
        words = huffman_ops.stream_words(payload, counts)
        rows = rans_ops.word_rows(words, counts)
        tables = huffman_ops.decoder_tables(lengths, dev)
        dec = (lambda: huffman_kernels.decode_symbols(rows, lens, *tables, n,
                                                      stride),
               lambda: huffman_ops.decode_symbols_plain(rows, lens, *tables,
                                                        n, stride))
        sym = hold(err, "huffman_decode", dec[0](), dec[1](),
                   f"kernel I at {what}")
        if sym.cpu().numpy().tobytes() != data:
            fail(f"kernel I did not invert kernel H at {what}")
        # H moves x, the lane lengths and the table in, the counts, the
        # bits and the payload's 2P bytes out
        work = {"huffman_encode": (nbytes(x2d, lens, tab, counts, bits)
                                   + 2 * words.numel(),
                                   coder_ops("huffman_encode", n)),
                "huffman_decode": (nbytes(rows, lens, *tables) + n,
                                   coder_ops("huffman_decode", n))}
        return f"K={k}, stride={stride}", {"huffman_encode": enc,
                                           "huffman_decode": dec}, work

    # lane_cases; the single-symbol run is one code of length 1, all bits
    # 0; then kernel H's edges: codes of 15 bits, K = 65,536, lanes of
    # length 0, strides of CHUNK - 1 and + 1, lanes whose words start
    # mid-u32 (one symbol a lane, 40 bits, 3 words)
    c = huffman_kernels.CHUNK
    cases = lane_cases(400) + [
        (64, skewed(20_000, 401)), (65536, textish(65536 * 3 + 5, 402)),
        (4096, textish(4096 - 100, 403)), (16, textish(16 * (c - 1) - 3, 404)),
        (16, textish(16 * (c + 1) - 3, 405)),
        (128, bytes(np.resize(np.array([0x61, 0x62], np.uint8), 128 * 40)))]
    for k, data in cases:
        case(data, k, f"K={k} n={len(data)}")

    # random word rows: windows that no code matches decode as perm[0]
    # and consume 16 bits in both versions
    rng = np.random.default_rng(405)
    lengths = np.zeros(256, np.uint8)
    lengths[[5, 9, 200]] = [2, 3, 3]
    tables = huffman_ops.decoder_tables(lengths, dev)
    k, stride = 300, 500
    rows = torch.from_numpy(rng.integers(0, 1 << 16, (300, k),
                                         dtype=np.int32)).to(dev)
    lens = torch.from_numpy(rng.integers(0, stride + 1, k,
                                         dtype=np.int32)).to(dev)
    active = torch.arange(stride, device=dev)[:, None] < lens[None, :]
    pick = (lambda out: out.view(stride, k)[active])
    hold(err, "huffman_decode",
         pick(huffman_kernels.decode_symbols(rows, lens, *tables, k * stride,
                                             stride)),
         pick(huffman_ops.decode_symbols_plain(rows, lens, *tables,
                                               k * stride, stride)),
         "kernel I on random word rows")

    # one lane over 200,000 random bytes: the container against the
    # oracle's (the plain step loop over 200,000 steps is too slow), a round
    # trip, then H alone timed
    lane1 = "200,000 random bytes lanes=1"
    data = np.random.default_rng(7).integers(0, 256, 200_000,
                                             np.uint8).tobytes()
    blob = ctt.compress(data, codec="huffman", device="cuda", lanes=1)
    if blob != ctt.compress(data, codec="huffman", backend="ref", lanes=1):
        fail(f"huffman at {lane1}: container differs from the numpy oracle")
    if ctt.decompress(blob, codec="huffman", device="cuda") != data:
        fail(f"huffman at {lane1} did not round-trip")
    n, _, x2d, lens = interleaved_inputs(data, 1, dev)
    _, tab = huffman_ops.encoder_table(x2d.reshape(-1)[:n])
    h1 = lambda: huffman_kernels.encode_stream(x2d, lens, tab)  # noqa: E731

    # held and timed at kennedy.xls's shape, kernel vs plain (the plain
    # loops run 4,023 steps a call: one rep); held there and at
    # grammar.lsp's (K = 2 over 1,861 steps), where the kernels alone are
    # timed; H's wrapper also as the median of 50 calls
    wrapper = []

    def time_h(fn):
        wrapper.append(median_call_ms(fn))
        return queued_ms(fn)

    ms, work, ms_at = time_at(("kennedy.xls", "grammar.lsp"), case,
                              lambda n: (rans_ops.pick_lanes(n),), 1,
                              f"{len(cases) + 3} CT-HUF1 cases (H, I; I also "
                              f"on random word rows) equal their plain "
                              f"versions; H at {lane1} writes the oracle's "
                              f"container", {"huffman_encode": time_h})
    ms_at["huffman_encode"][lane1] = time_h(h1)
    wrapper = dict(zip(("kennedy.xls", "grammar.lsp", lane1), wrapper))
    print(f"[kernels] H at {lane1}: {ms_at['huffman_encode'][lane1]:.4f} ms; "
          "through its wrapper (median of 50) " + ", ".join(
              f"{nm} {t:.4f}" for nm, t in wrapper.items()), flush=True)
    return err, ms, work, ms_at, wrapper


def o1_params(k: int, opts: dict) -> tuple:
    """(inc, limit1_log2, limit0_log2, blend_log2) of CT-RC3 at `opts`,
    the codec's defaults elsewhere."""
    return (opts.get("inc", o1_ref.pick_inc(k)),
            opts.get("limit1_log2", o1_ref.LIMIT1_LOG2),
            opts.get("limit0_log2", o1_ref.LIMIT0_LOG2),
            opts.get("blend_log2", o1_ref.BLEND_LOG2))


def table_edge_hits(rounds: int) -> bytes:
    """64 distinct symbols, then hits at table indices 15, 16, 31, 32, 47,
    48, 0 and 63 in turn: either side of kernel T's quad boundaries (16
    entries a thread)."""
    table = list(range(64))
    out = list(table)
    for _ in range(rounds):
        for idx in (15, 16, 31, 32, 47, 48, 0, 63):
            s = table.pop(idx)
            table.append(s)
            out.append(s)
    return bytes(out)


def o1_word_row_edges(dev, err):
    """V against its plain version on word rows cut short: one row (l4 =
    1), and rows ending with the longest lane's last word (three lanes'
    payloads end on a word edge; seed 3)."""
    data = np.random.default_rng(3).integers(0, 40, 8 * 120, np.uint8).tobytes()
    n, k = len(data), 8
    steps = -(-n // k)
    params = o1_params(k, {})
    x = to_dev(data, dev)
    lens = layout.lane_lengths(n, k, steps, dev)
    rows, sizes = expand.materialize_rows(o1_kernels.encode_events(
        layout.pad2d_chunked(x, k, steps), lens, *params))
    words = layout.decode_words(rows, sizes)
    if int(sizes.max()) % 4 or int((sizes % 4 == 0).sum()) != 3:
        fail(f"V's word-edge case lost its edges: sizes {sizes.tolist()}")
    for cut in (words[:1].contiguous(), words[:int(sizes.max()) // 4].contiguous()):
        out = hold(err, "o1_decode", o1_kernels.decode_symbols(cut, lens, n, steps, *params),
                   o1_ops.decode_symbols_plain(cut, lens, n, steps, *params),
                   f"kernel V on {cut.shape[0]} word rows")
        if cut.shape[0] > 1 and out.cpu().numpy().tobytes() != data:
            fail("kernel V on rows ending at a word edge did not decode")


def o1_step_zero(dev) -> str:
    """Fault P6: U raises ValueError at the first step whose t = range /
    tot_eff is 0 ("abracadabra" x 50 at one lane, blend_log2 14: step
    100), V raises CorruptContainerError at one (ten zeros at blend_log2
    23 on a zero payload: step 1), as their plain versions do."""
    data = b"abracadabra" * 50
    x2d = to_dev(data, dev).reshape(-1, 1)
    lens = torch.tensor([len(data)], dtype=torch.int32, device=dev)
    for fn in (o1_kernels.encode_events, o1_ops.encode_events_plain):
        try:
            fn(x2d, lens, 32, 11, 15, 14)
            fail(f"{fn.__name__} coded a step with t = 0")
        except ValueError as e:
            if "step 100, lane 0" not in str(e):
                fail(f"{fn.__name__}: {e}")
    words = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    ten = torch.tensor([10], dtype=torch.int32, device=dev)
    for fn in (o1_kernels.decode_symbols, o1_ops.decode_symbols_plain):
        try:
            fn(words, ten, 10, 10, 32, 16, 16, 23)
            fail(f"{fn.__name__} decoded a step with t = 0")
        except CorruptContainerError as e:
            if "step 1, lane 0" not in str(e):
                fail(f"{fn.__name__}: {e}")
    return "U and V raise at a step with t = 0, as their plain versions"


def s_segment_edges(dev, err) -> str:
    """Kernel S at 1, 3 and 64 steps a segment, K = 1, 2 and 8: 63 and 64
    distinct bytes between two occurrences, a byte back after many
    segments, one byte over many segments (a segment's bits inside one
    word), lanes of steps - 1 steps; K = 65,536 at 1 step a segment;
    kennedy.xls at a quarter and four times its default segment. Each
    against the plain version's payload and bit counts."""
    rng = np.random.default_rng(620)
    distinct = []
    for r in range(6):
        a, b = 200 + r, 250 - r
        distinct += [a] + list(range(63)) + [a] + [b] + list(range(64)) + [b]
    back = []
    for r in range(5):
        back += [7 + r] + list(rng.integers(0, 3, 130)) + [7 + r]
    lanes = [bytes(distinct), bytes(np.array(back, np.uint8)),
             b"\x00" * 400 + textish(300, 621)]
    cases = []
    for lane in lanes:
        for k in (1, 2, 8):
            x = np.frombuffer(lane, np.uint8)
            data = np.repeat(x, k)[:len(x) * k - k // 2].tobytes()
            cases += [(data, k, seg) for seg in (1, 3, 64)]
    cases.append((b"\x05" * 70_000 + rng.integers(0, 256, 60_000, np.uint8)
                  .tobytes(), 65536, 1))
    kennedy = corpus("kennedy.xls")
    seg = ase_ops.segment_steps(pick_lanes(len(kennedy)),
                                -(-len(kennedy) // pick_lanes(len(kennedy))))
    cases += [(kennedy, pick_lanes(len(kennedy)), max(1, seg // 4)),
              (kennedy, pick_lanes(len(kennedy)), seg * 4)]
    for data, k, seg in cases:
        n, stride, x2d, lens = interleaved_inputs(data, k, dev)
        hold(err, "ase_encode", ase_kernels.encode_words(x2d, lens, seg_steps=seg),
             ase_ops.encode_words_plain(x2d, lens),
             f"kernel S at K={k} n={n}, {seg} steps a segment")
    return f"S at {len(cases)} segment edges equals its plain version"


def u_chunk_edges(dev, err) -> str:
    """Kernel U with its passes alternating over chunks of a few steps
    (the model and the coder state carried across each edge): steps one
    below, at and one past the chunk, chunks of one step, the last lane
    ending mid-chunk, the u32 table and 2,048 lanes, each against the plain
    version's events and the oracle's container; kennedy.xls in chunks of
    256 steps against U in one chunk."""
    text = textish(8 * 60, 611)
    cases = [(text, 8, {}, 61), (text, 8, {}, 60), (text, 8, {}, 59),
             (textish(4 * 50, 612), 4, {}, 1),
             (textish(8 * 50 + 17, 613), 8, {}, 20),
             (b"\x07" * 6000 + bytes(range(256)) * 4, 4,
              dict(blend_log2=0, limit1_log2=17), 300),
             (textish(2048 * 6 + 5, 614), 2048, {}, 2)]
    for data, k, opts, chunk in cases:
        n, steps, x2d, lens = coder_inputs(data, k, dev)
        params = o1_params(k, opts)
        what = f"K={k} n={n} {opts} in chunks of {chunk} steps"
        ev = hold(err, "o1_encode", o1_kernels.encode_events(
            x2d, lens, *params, chunk_steps=chunk),
            o1_ops.encode_events_plain(x2d, lens, *params), f"kernel U at {what}")
        rows, sizes = expand.materialize_rows(ev)
        blob = layout.assemble(lambda wide: o1_ops.header(n, k, wide, *params),
                               rows.cpu().numpy(), sizes.cpu().numpy())
        if blob != o1_ref.o1_encode(data, lanes=k, **opts):
            fail(f"kernel U at {what}: not the oracle's container")
    data = corpus("kennedy.xls")
    n, steps, x2d, lens = coder_inputs(data, pick_lanes(len(data)), dev)
    params = o1_params(x2d.shape[1], {})
    hold(err, "o1_encode", o1_kernels.encode_events(x2d, lens, *params,
                                                    chunk_steps=256),
         o1_kernels.encode_events(x2d, lens, *params),
         "kernel U at kennedy.xls in chunks of 256 steps")
    return (f"U over chunks of 1 to 300 steps ({len(cases)} cases, and "
            f"kennedy.xls in {-(-steps // 256)} chunks) equals its plain "
            f"version and the oracle")


# fault P7's repair: CT-RC3 streams past the u32 kernels' old guard (256 +
# inc*L*K >= 2^32 - 1 at a limit_log2 of 32 or more), where U and V keep
# their counts and totals in 64 bits: (what, K, steps, params, zeros)
PAST_GUARD = [
    ("4,096 x 4,200 zeros, limits 32/11, blend 5", 4096, 4200,
     (255, 32, 11, 5), True),
    ("65,536 x 263 random bytes, limits 32/11", 65536, 263, (255, 32, 11, 0),
     False),
    ("65,536 x 263 random bytes, limits 33/11", 65536, 263, (255, 33, 11, 0),
     False)]


def step_outcome(fn):
    """-> ("ok", fn's output) or (the error's type, its message)."""
    try:
        return "ok", fn()
    except ValueError as e:
        return type(e).__name__, str(e)


def held_outcome(err, name, got, want, what):
    """Hold a kernel's outcome against its plain version's: the same
    output, or the same step error."""
    if got[0] != want[0] or (got[0] != "ok" and got[1] != want[1]):
        fail(f"{what}: {got[0]} {got[1] if got[0] != 'ok' else ''} != plain "
             f"{want[0]} {want[1] if want[0] != 'ok' else ''}")
    if got[0] == "ok":
        hold(err, name, got[1], want[1], what)
    return got


def o1_past_guard(dev, err, cases=PAST_GUARD) -> str:
    """Fault P7: U and V at streams past the old guard, each against its
    plain version (the same events, decoded back by V, or the same step
    error, step and lane; V on zero word rows where U raised), and the
    64-bit instantiation's times there (ms, 3 reps) and at kennedy.xls
    beside the u32 one's."""
    rng = np.random.default_rng(700)
    times = []
    for what, k, steps, params, zeros in cases:
        if not o1_ops.counts_long(steps, k, *params[:3]):
            fail(f"CT-RC3 {what}: inside the u32 guard")
        x = np.zeros(k * steps, np.uint8) if zeros \
            else rng.integers(0, 256, k * steps, np.uint8)
        x2d = torch.from_numpy(x).to(dev).reshape(k, steps).T.contiguous()
        lens = torch.full((k,), steps, dtype=torch.int32, device=dev)
        enc = held_outcome(
            err, "o1_encode",
            step_outcome(lambda: o1_kernels.encode_events(x2d, lens, *params)),
            step_outcome(lambda: o1_ops.encode_events_plain(x2d, lens,
                                                            *params)),
            f"kernel U at {what}")
        words = layout.decode_words(*expand.materialize_rows(enc[1])) \
            if enc[0] == "ok" else torch.zeros((1, k), dtype=torch.int32,
                                               device=dev)
        dec_k = lambda: o1_kernels.decode_symbols(  # noqa: E731
            words, lens, k * steps, steps, *params)
        dec = held_outcome(
            err, "o1_decode", step_outcome(dec_k),
            step_outcome(lambda: o1_ops.decode_symbols_plain(
                words, lens, k * steps, steps, *params)),
            f"kernel V at {what}")
        if enc[0] == "ok" and not torch.equal(dec[1], x2d.T.reshape(-1)):
            fail(f"kernel V did not invert kernel U at {what}")
        # a call that raises has run every step before its flag is read
        u_ms = cuda_ms(lambda: step_outcome(lambda: o1_kernels.encode_events(
            x2d, lens, *params)), 3)
        v_ms = cuda_ms(lambda: step_outcome(dec_k), 3)
        raised = "" if enc[0] == "ok" else f" (both raise {enc[1]!r})"
        times.append(f"{what}: U {u_ms:.3f}, V {v_ms:.3f}{raised}")
    data = corpus("kennedy.xls")
    n, steps, x2d, lens = coder_inputs(data, pick_lanes(len(data)), dev)
    params = o1_params(x2d.shape[1], {})
    words = layout.decode_words(*expand.materialize_rows(
        o1_kernels.encode_events(x2d, lens, *params)))
    at = {}
    for long_counts in (False, True):
        at[long_counts] = (
            cuda_ms(lambda: o1_kernels.encode_events(
                x2d, lens, *params, long_counts=long_counts), 5),
            cuda_ms(lambda: o1_kernels.decode_symbols(
                words, lens, n, steps, *params, long_counts=long_counts), 5))
    times.append("kennedy.xls u32/u64: U {:.3f}/{:.3f}, V {:.3f}/{:.3f}".format(
        at[False][0], at[True][0], at[False][1], at[True][1]))
    return (f"U and V past the u32 guard equal their plain versions at "
            f"{len(cases)} streams; the 64-bit instantiation's ms: "
            + "; ".join(times))


def phase_kernels_ase_o1(dev):
    """S, T (CT-ASE1) and U, V (CT-RC3) against their plain step loops,
    and the containers of their cases against the oracles."""
    err = dict.fromkeys(("ase_encode", "ase_decode", "o1_encode",
                         "o1_decode"), 0)
    # each plain version runs once a case, timed (time_at reads it at
    # kennedy.xls rather than running the plain loop again)
    plain_done = {}

    def plain(nm, fn):
        out, plain_done[nm] = run_ms(fn)
        return out

    def ase_case(data, k, what):
        """Hold S and T against their plain versions on `data`; -> (shape,
        {kernel: (kernel call, plain call)}, {kernel: (bytes, ops)})."""
        n, stride, x2d, lens = interleaved_inputs(data, k, dev)
        stats = {}
        enc = (lambda: ase_kernels.encode_words(x2d, lens),
               lambda: ase_ops.encode_words_plain(x2d, lens))
        payload, bits = hold(err, "ase_encode", enc[0](), plain(
            "ase_encode", lambda: ase_ops.encode_words_plain(x2d, lens,
                                                             stats)),
            f"kernel S at {what}")
        counts = (bits.to(torch.int64) + 15) // 16
        words = payload[:int(counts.sum())].contiguous()
        bases = (torch.cumsum(counts, 0) - counts).to(torch.int32)
        args = (words, bases, counts.to(torch.int32), lens, n, stride)
        dec = (lambda: ase_kernels.decode_symbols(*args),
               lambda: ase_ops.decode_symbols_plain(*args))
        sym = hold(err, "ase_decode", dec[0](), plain("ase_decode", dec[1]),
                   f"kernel T at {what}")
        if sym.cpu().numpy().tobytes() != data:
            fail(f"kernel T did not invert kernel S at {what}")
        table = stats["table_ops"]
        work = {"ase_encode": (nbytes(x2d, lens, words, bits),
                               table + coder_ops("ase_encode", n)),
                "ase_decode": (nbytes(*args[:4]) + n,
                               table + coder_ops("ase_decode", n))}
        return f"K={k}, stride={stride}", {"ase_encode": enc,
                                           "ase_decode": dec}, work

    def o1_case(data, k, what, **opts):
        """Hold U and V against their plain versions on `data`."""
        n, steps, x2d, lens = coder_inputs(data, k, dev)
        params = o1_params(k, opts)
        stats = {}
        enc = (lambda: o1_kernels.encode_events(x2d, lens, *params),
               lambda: o1_ops.encode_events_plain(x2d, lens, *params))

        def plain_passes():
            trip, _ = o1_ops.model_triples_plain(x2d, lens, *params,
                                                 stats=stats)
            return trip, o1_ops.coder_events_plain(trip)[0]

        # U's plain version is its passes' composition: each pass alone and
        # U whole held against it
        trip_p, ev_p = plain("o1_encode", plain_passes)
        ev = hold(err, "o1_encode", enc[0](), ev_p, f"kernel U at {what}")
        hold(err, "o1_encode", o1_kernels.model_triples(x2d, lens, *params),
             trip_p, f"kernel U's model pass at {what}")
        hold(err, "o1_encode", o1_kernels.coder_events(trip_p), ev_p,
             f"kernel U's coder pass at {what}")
        words = layout.decode_words(*expand.materialize_rows(ev))
        dec = (lambda: o1_kernels.decode_symbols(words, lens, n, steps,
                                                 *params),
               lambda: o1_ops.decode_symbols_plain(words, lens, n, steps,
                                                   *params))
        sym = hold(err, "o1_decode", dec[0](), plain("o1_decode", dec[1]),
                   f"kernel V at {what}")
        if sym.cpu().numpy().tobytes() != data:
            fail(f"kernel V did not invert kernel U at {what}")
        x = np.frombuffer(data, np.uint8).astype(np.int64)
        model = (2 * int(((x >> 4) + (x & 15)).sum()) + steps * 256
                 + stats["rows_halved"] * 256 * OPS_PER_TABLE_CELL)
        work = {"o1_encode": (nbytes(x2d, lens, ev),
                              model + coder_ops("o1_encode", n)),
                "o1_decode": (nbytes(words, lens) + n,
                              model + coder_ops("o1_decode", n))}
        wide = " u32 table" if o1_ops.table_wide(k, *params[:2]) else ""
        return (f"K={k}, L={steps}{wide}", {"o1_encode": enc,
                                            "o1_decode": dec}, work)

    def containers(codec, cases, oracle_fn):
        for data, k, opts in cases:
            blob = ctt.compress(data, codec=codec, device="cuda", lanes=k,
                                **opts)
            if blob != oracle_fn(data, lanes=k, **opts) \
                    or ctt.decompress(blob, codec=codec, device="cuda") != data:
                fail(f"{codec} K={k} n={len(data)} {opts}: not the oracle's "
                     f"container, or no round trip")

    # CT-ASE1: runs (every hit at d = 0), all 256 values cycled (a full
    # table evicting every step), exactly 64 and 65 distinct symbols, n not
    # a multiple of K, K = 1 and K = 65,536 (lanes of length 0 too)
    rng = np.random.default_rng(600)
    seeded = lambda n, a: rng.integers(0, a, n, dtype=np.uint8).tobytes()  # noqa: E731
    # T's quads: lanes whose first words sit at offsets 0, 2, 1, 3 mod 4
    # (seed 1; the last lane ends on the payload's last word), hits either
    # side of the quads' thread boundaries, a full table evicting every
    # step at K = 2
    ase_cases = [(b"\x33" * 3000 + b"\x44" * 3000, 2, {}),
                 (bytes(range(256)) * 40, 4, {}),
                 (seeded(4000, 64), 1, {}), (seeded(4000, 65), 1, {}),
                 (seeded(256 * 40 + 7, 90), 256, {}),
                 (textish(4000, 601), 1, {}),
                 (b"\x05" * 70_000 + seeded(60_000, 256), 65536, {}),
                 (np.random.default_rng(1).integers(0, 70, 2001, dtype=np.uint8)
                  .tobytes(), 4, {}),
                 (table_edge_hits(150), 1, {}),
                 (bytes(range(256)) * 6, 2, {})]
    for data, k, _ in ase_cases:
        ase_case(data, k, f"K={k} n={len(data)}")
    containers("ase", ase_cases, ase_ref.ase_encode)
    # CT-RC3: rows that halve nearly every step (limit1_log2 9), t0
    # rescales, n < K (empty lanes), one-byte runs (every update on one
    # cell), the u32 table (blend 0, limit1_log2 17: t1[7][7] passes 2^16)
    # at one and four lanes, 2,048 lanes (two a thread) and K = 65,536
    u32 = b"\x07" * 6000 + bytes(range(256)) * 4
    # V's second design: every row halved every step (limit1_log2 8), rows
    # halving at 64 lanes (9), t0 every step (limit0_log2 8), 64 lanes on
    # the same bytes (all of them taking a row over its limit in one step),
    # one-byte runs at 256 and 2,048 lanes (every atomic on one address; at
    # 2,048 grouped), 256 symbols in one warp (K = 32), K = 1, 32 and 64
    o1_cases = [(textish(3000, 602), 2, dict(limit1_log2=9)),
                (seeded(6000, 50), 4, dict(limit0_log2=10, inc=16)),
                (b"abcde", 8, {}), (b"\x61" * 20_000, 64, dict(inc=255)),
                (u32, 1, dict(blend_log2=0, limit1_log2=17)),
                (u32, 4, dict(blend_log2=0, limit1_log2=17)),
                (textish(2048 * 6 + 5, 603), 2048, {}),
                (seeded(65536 * 2 + 100, 256), 65536, {}),
                (textish(600, 604), 2, dict(limit1_log2=8)),
                (textish(64 * 50 + 3, 605), 64, dict(limit1_log2=9)),
                (seeded(1200, 60), 4, dict(limit0_log2=8)),
                (textish(80, 606) * 64, 64, {}),
                (bytes(256 * 40), 256, {}), (bytes(2048 * 6), 2048, {}),
                (bytes(i % 256 for i in range(32 * 150)), 32, {}),
                (textish(800, 607), 1, {}), (textish(32 * 60 + 5, 608), 32, {}),
                (textish(64 * 40 + 3, 609), 64, {})]
    # fault P6: parameters past C8's bound where the oracle ends (b"a" and
    # alice29.txt[:488] at 64 lanes, grammar.lsp at 2, xargs.1 at 4 with
    # limit0_log2 16; 20,000 zeros at one lane, held to the oracle's
    # container alone: the plain loops would take most of a minute)
    p6 = dict(inc=32, limit1_log2=16, limit0_log2=12, blend_log2=8)
    p6_cases = [(b"a", 64, p6), (corpus("alice29.txt")[:488], 64, p6),
                (corpus("grammar.lsp"), 2, p6),
                (corpus("xargs.1"), 4, dict(p6, limit0_log2=16))]
    o1_cases += p6_cases
    for data, k, opts in o1_cases:
        o1_case(data, k, f"K={k} n={len(data)} {opts}", **opts)
    o1_cases.append((bytes(20_000), 1, p6))
    p6_steps = o1_step_zero(dev)
    o1_word_row_edges(dev, err)
    u_chunks = u_chunk_edges(dev, err)
    past_guard = o1_past_guard(dev, err)
    s_edges = s_segment_edges(dev, err)
    containers("adaptive_o1", o1_cases, o1_ref.o1_encode)
    print(f"[kernels] ok {len(ase_cases)} CT-ASE1 and {len(o1_cases)} CT-RC3 "
          f"containers equal the oracle's and round-trip ({len(p6_cases) + 1} "
          f"past C8's bound); {p6_steps}; {u_chunks}; {s_edges}", flush=True)
    print(f"[kernels] ok {past_guard}", flush=True)

    # held and timed at kennedy.xls's shapes (ase K = 256, stride 4,023;
    # CT-RC3 K = 256, L = 4,023), kernel vs plain; held there and at
    # grammar.lsp's (K = 2), the kernels alone timed
    lanes = lambda n: (pick_lanes(n),)  # noqa: E731
    ms, work, ms_at = time_at(
        ("kennedy.xls", "grammar.lsp"), ase_case, lanes, 1,
        f"{len(ase_cases) + 2} CT-ASE1 cases (S, T) equal their plain "
        f"versions", plain_done=plain_done)
    o1 = time_at(("kennedy.xls", "grammar.lsp"), o1_case, lanes, 1,
                 f"{len(o1_cases) + 2} CT-RC3 cases (U, V) equal their plain "
                 f"versions", plain_done=plain_done)
    for d, more in zip((ms, work, ms_at), o1):
        d.update(more)
    return err, ms, work, ms_at


def ans2_params(k: int, n: int, opts: dict) -> tuple:
    """(inc, limit_log2, refresh_log2) of CT-ANS2 at `opts`, the codec's
    defaults elsewhere."""
    return (opts.get("inc", ans2_ref.ANS2_INC_DEFAULT),
            opts.get("limit_log2", ans2_ref.ANS2_LIMIT_LOG2_DEFAULT),
            opts.get("refresh_log2", ans2_ref.default_refresh_log2(k, n)))


def normalize_cases() -> np.ndarray:
    """Count vectors [B, 256] for the normalize alone (seeded): random at
    every scale to past 2^32, sparse, one dominant symbol, one symbol alone
    (rule 5), all equal, all zero."""
    rng = np.random.default_rng(710)
    rows = [rng.integers(0, 10 ** int(rng.integers(1, 12)), 256)
            for _ in range(200)]
    for _ in range(50):
        h = rng.integers(1, 1000, 256)
        h[rng.random(256) < 0.9] = 0
        rows.append(h)
    dominant = np.ones(256, np.int64)
    dominant[9] = 1 << 40
    alone = np.zeros(256, np.int64)
    alone[255] = 12345
    rows += [dominant, alone, np.full(256, 777), np.full(256, 1 << 33),
             np.zeros(256)]
    return np.stack(rows).astype(np.int64)


def phase_kernels_ans2(dev):
    """W, X and Y (CT-ANS2) against their plain versions, the normalize
    they share against the oracle's, the cases' containers against the
    oracle's, and the model past 2^32."""
    err = dict.fromkeys(("ans2_model", "ans2_encode", "ans2_decode"), 0)
    plain_done = {}

    def plain(nm, fn):
        out, plain_done[nm] = run_ms(fn)
        return out

    def case(data, k, what, **opts):
        """Hold W, X and Y against their plain versions on `data`; ->
        (shape, {kernel: (kernel call, plain call)}, {kernel: (bytes,
        ops)})."""
        n, steps, x2d, lens = interleaved_inputs(data, k, dev)
        params = ans2_params(k, n, opts)
        r_log2 = params[2]
        mdl = (lambda: ans2_kernels.window_tables(x2d, n, *params),
               lambda: ans2_ops.window_tables_plain(x2d, n, *params))
        entries = hold(err, "ans2_model", mdl[0](),
                       plain("ans2_model", mdl[1]), f"kernel W at {what}")
        enc = (lambda: ans2_kernels.encode_events(x2d, lens, entries, r_log2),
               lambda: ans2_ops.encode_events_plain(x2d, lens, entries,
                                                    r_log2))
        ev, st = hold(err, "ans2_encode", enc[0](),
                      plain("ans2_encode", enc[1]), f"kernel X at {what}")
        words = ans2_ops.stream_words(ev).to(torch.int16)
        dec = (lambda: ans2_kernels.decode_symbols(words, st, n, *params),
               lambda: ans2_ops.decode_symbols_plain(words, st, n, *params))
        sym = hold(err, "ans2_decode", dec[0](),
                   plain("ans2_decode", dec[1]), f"kernel Y at {what}")
        if sym.cpu().numpy().tobytes() != data:
            fail(f"kernel Y did not invert kernel X at {what}")
        cells = entries.shape[0] * 256 * OPS_PER_ANS2_CELL
        work = {"ans2_model": (n + nbytes(entries),
                               coder_ops("ans2_model", n) + cells),
                "ans2_encode": (nbytes(x2d, lens, entries, ev, st),
                                coder_ops("ans2_encode", n)),
                "ans2_decode": (nbytes(words, st) + n,
                                coder_ops("ans2_decode", n) + cells)}
        return (f"K={k}, steps={steps}, {entries.shape[0]} windows",
                {"ans2_model": mdl, "ans2_encode": enc, "ans2_decode": dec},
                work)

    # the normalize alone, on count vectors that no CT-ANS2 model reaches
    # (absent symbols, rule 5) as well as ones it does
    counts = normalize_cases()
    got = ans2_kernels.normalize_tables(torch.from_numpy(counts).to(dev))
    want = ans2_ops.normalize_tables_plain(torch.from_numpy(counts))
    hold(err, "ans2_model", got.cpu(), want,
         f"the normalize at {len(counts)} count vectors")
    for row, fw in zip(counts, ans2_ops.entry_tables(want)[0].numpy()):
        if row.sum() and not np.array_equal(fw, normalize_freqs(row, 14)):
            fail("normalize_tables_plain is not the oracle's normalize")

    # a table every step (refresh_log2 0), warm-up windows only
    # (refresh_log2 past bitlen(steps)), a rescale at nearly every window
    # (limit_log2 9), n < K, n not a multiple of K, a one-byte run, all
    # 256 values, K = 1 and K = 65,536
    rng = np.random.default_rng(700)
    seeded = lambda n, a: rng.integers(0, a, n, dtype=np.uint8).tobytes()  # noqa: E731
    cases = [(textish(4000, 701), 4, dict(refresh_log2=0)),
             (textish(6000, 702), 8, dict(refresh_log2=40)),
             (textish(9000, 703), 16, dict(limit_log2=9, inc=255)),
             (b"abcde", 8, {}),
             (seeded(256 * 30 + 7, 90), 256, dict(limit_log2=12)),
             (b"\x61" * 20_000, 64, dict(inc=255, limit_log2=200)),
             (bytes(range(256)) * 40, 32, dict(refresh_log2=2)),
             (seeded(6000, 200), 1, {}),
             (b"\x05" * 70_000 + seeded(70_000, 256), 65536, {}),
             # Y's second design: more words than its ring of 8,192 holds,
             # every lane refilling at the same steps, a window every step
             # at one warp and past it, K = 32 and 64 around the one-warp
             # cut, the states in shared memory (16,384 lanes) and in
             # global scratch with the ring (32,768)
             (seeded(64 * 400, 256), 64, {}),
             (b"\x42" * (64 * 300), 64, dict(inc=1)),
             (seeded(32 * 60, 70), 32, dict(refresh_log2=0)),
             (seeded(64 * 40, 70), 64, dict(refresh_log2=0)),
             (corpus("fields.c")[:32 * 70 + 9], 32, {}),
             (corpus("fields.c")[:64 * 40 + 33], 64, {}),
             (seeded(16384 * 5 + 77, 100), 16384, {}),
             (seeded(32768 * 3 + 5, 100), 32768, {}),
             # X's second design: window edges inside a run of 16
             # (refresh_log2 3), lanes of steps - 1 steps at 32 steps a
             # window, K = 1 at 16 steps a window, one staged step, a table
             # every step at grammar.lsp's shape
             (seeded(8 * 300 + 3, 90), 8, dict(refresh_log2=3)),
             (seeded(32 * 120 - 5, 60), 32, dict(refresh_log2=5)),
             (textish(1200, 704), 1, dict(refresh_log2=4, limit_log2=12)),
             (seeded(64 * 17 - 3, 256), 64, dict(refresh_log2=5)),
             (corpus("grammar.lsp"), 2, dict(refresh_log2=0)),
             # W's second design: one step at 65,536 lanes (one table), n =
             # 1, no rescale (limit_log2 63) and one every window (9) at
             # 256 lanes, windows of 32 histogram rows (65,536 lanes,
             # windows of 8 steps), the walk's chunks crossed many times
             # (3,000 windows), zeros (one byte's runs); X's global-read
             # path at K = 2,048 (windows of 8 steps)
             (seeded(50_000, 256), 65536, {}),
             (b"q", 1, {}),
             (textish(256 * 500, 706), 256, dict(limit_log2=63)),
             (textish(256 * 500, 707), 256, dict(limit_log2=9)),
             (seeded(65536 * 40, 50), 65536, dict(refresh_log2=3)),
             (textish(3000, 705), 1, dict(refresh_log2=0)),
             (bytes(200_000), 64, {}),
             (corpus("kennedy.xls"), 2048, {})]
    for data, k, opts in cases:
        case(data, k, f"K={k} n={len(data)} {opts}", **opts)
        blob = ctt.compress(data, codec="adaptive_rans", device="cuda",
                            lanes=k, **opts)
        if blob != ans2_ref.ans2_encode(data, lanes=k, **opts) or \
                ctt.decompress(blob, codec="adaptive_rans",
                               device="cuda") != data:
            fail(f"adaptive_rans K={k} n={len(data)} {opts}: not the "
                 f"oracle's container, or no round trip")
    wide = wide_model_case(dev, err)
    cut = y_cut_stream(dev, err)
    print(f"[kernels] ok the normalize at {len(counts)} count vectors and "
          f"{len(cases)} CT-ANS2 containers equal the oracle's and "
          f"round-trip; {wide}; {cut}", flush=True)

    # held and timed at kennedy.xls's shape (K = 256, 4,023 steps, 69
    # windows), kernel vs plain; held there and at grammar.lsp's (K = 2,
    # 1,861 steps, 35 windows), the kernels alone timed
    ms, work, ms_at = time_at(
        ("kennedy.xls", "grammar.lsp"), case, lambda n: (pick_lanes(n),), 1,
        f"{len(cases) + 2} CT-ANS2 cases (W, X, Y) equal their plain "
        f"versions", plain_done=plain_done)
    return err, ms, work, ms_at


def y_cut_stream(dev, err) -> str:
    """Kernel Y on a word stream cut 0, 3 and 1,000 words short (K = 64:
    the cut of 3 inside the last refilling step's words), from a 16-byte
    aligned tensor and one 2 bytes off (the wrapper copies it): equal to
    the plain decoder, which reads 0 past the end."""
    data, k = textish(64 * 200, 710), 64
    n, steps, x2d, lens = interleaved_inputs(data, k, dev)
    params = ans2_params(k, n, {})
    entries = ans2_kernels.window_tables(x2d, n, *params)
    ev, st = ans2_kernels.encode_events(x2d, lens, entries, params[2])
    words = ans2_ops.stream_words(ev).to(torch.int16)
    for cut in (0, 3, 1000):
        w = words[:words.numel() - cut]
        for src in (w, torch.cat([w[:1], w])[1:]):
            out = hold(err, "ans2_decode",
                       ans2_kernels.decode_symbols(src, st, n, *params),
                       ans2_ops.decode_symbols_plain(src.contiguous(), st, n,
                                                     *params),
                       f"kernel Y on a stream cut {cut} words short")
            if (out.cpu().numpy().tobytes() == data) != (cut == 0):
                fail(f"kernel Y on a stream cut {cut} words short")
    return "Y on word streams cut 0, 3 and 1,000 words short equals its plain version"


def wide_model_case(dev, err) -> str:
    """8,192 lanes of 4,100 steps of one byte at inc 255, refresh_log2 13:
    the counts pass 2^32. W's tables against the oracle's model pass
    (`_snapshots_and_counts`) at limit_log2 40, 33 and 32 (32 rescales at
    step 4,096), X and Y round trips; at 32 also X and Y against their
    plain versions."""
    k, steps, inc, r_log2 = 8192, 4100, 255, 13
    data = b"\x07" * (k * steps)
    n, steps, x2d, lens = interleaved_inputs(data, k, dev)
    x_host = np.frombuffer(data, np.uint8).reshape(steps, k)
    for limit_log2 in (40, 33, 32):
        params = (inc, limit_log2, r_log2)
        entries = ans2_kernels.window_tables(x2d, n, *params)
        freqs, cums = ans2_ops.entry_tables(entries)
        snaps = ans2_ref._snapshots_and_counts(x_host, n, k, inc,
                                               1 << limit_log2, 1 << r_log2)
        want = (torch.from_numpy(np.stack([f for f, _ in snaps])
                                 .astype(np.int64)),
                torch.from_numpy(np.stack([c for _, c in snaps])
                                 .astype(np.int64)))
        hold(err, "ans2_model", (freqs.cpu(), cums.cpu()), want,
             f"kernel W past 2^32 at limit_log2 {limit_log2}")
        ev, st = ans2_kernels.encode_events(x2d, lens, entries, r_log2)
        words = ans2_ops.stream_words(ev).to(torch.int16)
        if limit_log2 == 32:
            hold(err, "ans2_encode", (ev, st), ans2_ops.encode_events_plain(
                x2d, lens, entries, r_log2), "kernel X past 2^32")
        sym = ans2_kernels.decode_symbols(words, st, n, *params)
        if limit_log2 == 32:
            hold(err, "ans2_decode", sym, ans2_ops.decode_symbols_plain(
                words, st, n, *params), "kernel Y past 2^32")
        if not bool((sym == 7).all()) or sym.numel() != n:
            fail(f"X and Y past 2^32 at limit_log2 {limit_log2}: no round "
                 f"trip")
    return (f"the model past 2^32 ({k} lanes x {steps} steps, inc {inc}) "
            f"equals the oracle's at limit_log2 40, 33, 32 and round-trips")


def zipf(n: int, seed: int) -> bytes:
    """Zipf-distributed bytes (seeded): rare symbols keep a count of 1
    while CT-RC2's total nears 2^17, so some lanes take a third slot."""
    rng = np.random.default_rng(seed)
    return np.minimum(rng.zipf(1.3, n) - 1, 255).astype(np.uint8).tobytes()


def concat_corpus() -> bytes:
    """The 11 Canterbury files concatenated in name order."""
    return b"".join(corpus(nm) for nm in sorted(EXPECTED_SIZES["rcx"]))


def pipeline_stages(data: bytes, dev):
    """The bytes the default pipeline's mtf1 stage and its coder stage
    (adaptive_range) take for `data`, made on the card."""
    bwt = ctt.compress(data, codec="blocksort", device=dev, block_log2=19)
    return bwt, ctt.compress(ctt.compress(bwt, codec="mtf1", device=dev),
                             codec="rle0", device=dev)


def exact_args(n: int, k: int | None = None, static: bool = False):
    """(K, static, inc, limit_log2) at the codecs' defaults for n bytes."""
    k = k or pick_lanes(n)
    return (k, static, 0, 16) if static else (k, False,
                                              *adaptive_params_for(k))


def phase_kernels_exact(dev):
    """J and L against their plain step loops (range_ops)."""
    err = {"rc_exact_encode": 0, "rc_exact_decode": 0}

    def case(data, k, static, inc, limit_log2, what):
        """Hold J and L against their plain versions on `data`; -> (shape,
        {kernel: (kernel call, plain call)}, {kernel: (bytes, ops)})."""
        n, stride, x2d, lens = interleaved_inputs(data, k, dev)
        freqs = torch.from_numpy(normalize_freqs(np.bincount(
            np.frombuffer(data, np.uint8), minlength=256), 16).astype(
                np.int32)).to(dev) if static else None
        args = (freqs, inc, limit_log2)
        enc = (lambda: range_kernels.encode_events(x2d, lens, *args),
               lambda: range_ops.encode_events_plain(x2d, lens, *args))
        ev = hold(err, "rc_exact_encode", enc[0](), enc[1](),
                  f"kernel J at {what}")
        words = layout.decode_words(*expand.materialize_rows(ev))
        dec = (lambda: range_kernels.decode_symbols(words, lens, n, stride,
                                                    *args),
               lambda: range_ops.decode_symbols_plain(words, lens, n, stride,
                                                      *args))
        sym = hold(err, "rc_exact_decode", dec[0](), dec[1](),
                   f"kernel L at {what}")
        if sym.cpu().numpy().tobytes() != data:
            fail(f"kernel L did not invert kernel J at {what}")
        table = (0 if static else stride) * 256 * OPS_PER_TABLE_CELL
        extra = 0 if static else 1024      # the static table in
        work = {"rc_exact_encode": (nbytes(x2d, lens, ev) + extra,
                                    coder_ops("rc_exact_encode", n) + table),
                "rc_exact_decode": (nbytes(words, lens) + n + extra,
                                    coder_ops("rc_exact_decode", n) + table)}
        slots = (ev.shape[0] - 2) // stride
        return (f"K={k}, stride={stride}, {slots} slots"
                + (", static" if static else f", limit_log2 {limit_log2}"),
                {"rc_exact_encode": enc, "rc_exact_decode": dec}, work)

    # CT-RC2 at one lane, 8 lanes (limit_log2 18: three slots), 256 lanes
    # with n not a multiple of K, 1,024 lanes (limit_log2 17, three slots,
    # Zipf bytes taking the third), 8,192 lanes (L a cluster of 2), a
    # one-byte run (every lane's update on one count), inc 255 at
    # limit_log2 16 (the total passes 2^16: three slots), 512 lanes (J over
    # 8 CTAs), 16,384 lanes (L a cluster of 4) and a one-byte run over
    # 65,536 (J over 256 CTAs, L a cluster of 8); CT-RC1 at one lane, 128
    # lanes (J over two CTAs), 2,048 lanes and one-byte runs over 64 and
    # 65,536 lanes
    cases = [(textish(3000, 400), 1, False, 24, 16),
             (textish(8 * 400 + 3, 401), 8, False, 24, 18),
             (textish(256 * 50 + 7, 402), 256, False, 24, 16),
             (zipf(1024 * 40 + 9, 403), 1024, False, 24, 17),
             (textish(8192 * 20 + 5, 404), *exact_args(0, 8192)),
             (b"\x61" * (64 * 90 + 1), 64, False, 24, 16),
             (corpus("grammar.lsp"), 1024, False, 255, 16),
             (zipf(512 * 30 + 7, 407), 512, False, 24, 16),
             (textish(16384 * 3 + 5, 408), *exact_args(0, 16384)),
             (b"\x61" * (65536 * 3 + 1), *exact_args(0, 65536)),
             (textish(2500, 405), 1, True, 0, 16),
             (textish(128 * 40 + 3, 409), 128, True, 0, 16),
             (zipf(2048 * 30 + 3, 406), 2048, True, 0, 16),
             (b"\x61" * (64 * 90 + 1), 64, True, 0, 16),
             (b"\x61" * (65536 * 3 + 1), 65536, True, 0, 16)]
    for data, *args in cases:
        case(data, *args, f"K={args[0]} n={len(data)} static={args[1]} "
                          f"inc={args[2]} limit_log2={args[3]}")
    # that case's container and the widest lane counts' against the
    # oracle, and back
    wide = [("adaptive_range", corpus("grammar.lsp"),
             dict(lanes=1024, inc=255, limit_log2=16), None)] + [
        (codec, corpus("fields.c"), dict(lanes=k), RANGE_WIDE_BYTES[codec, k])
        for codec, k in RANGE_WIDE_BYTES]
    for codec, data, opts, size in wide:
        blob = ctt.compress(data, codec=codec, device="cuda", **opts)
        if blob != ctt.compress(data, codec=codec, backend="ref", **opts) \
                or size not in (None, len(blob)) \
                or ctt.decompress(blob, codec=codec, device="cuda") != data:
            fail(f"{codec} {opts}: {len(blob)} bytes, not the oracle's "
                 f"container ({size}) or no round trip")
    print(f"[kernels] ok {len(wide)} CT-RC1/CT-RC2 containers (inc 255 at "
          f"limit_log2 16; fields.c at 16,384 to 65,536 lanes) equal the "
          f"oracle's and round-trip", flush=True)

    # held and timed at kennedy.xls's adaptive_range shape (K = 256, 4,023
    # steps), kernel vs plain; held there and at grammar.lsp's (K = 2, 1,861
    # steps), the kernels alone timed; then, kernels alone, the
    # pipeline's coder stage at kennedy.xls, static_range at kennedy.xls
    # and the 11 files concatenated (K = 1,024, three slots)
    ms, work, ms_at = time_at(
        ("kennedy.xls", "grammar.lsp"), case, exact_args, 1,
        f"{len(cases) + 2} CT-RC1/CT-RC2 cases (J, L) equal their plain "
        f"versions")
    rc_in = pipeline_stages(corpus("kennedy.xls"), dev)[1]
    for what, data, args in (
            ("kennedy.xls pipeline coder stage", rc_in, exact_args(len(rc_in))),
            ("kennedy.xls static_range", corpus("kennedy.xls"),
             exact_args(1_029_744, static=True)),
            ("11 files concatenated", concat_corpus(),
             exact_args(2_810_784))):
        shape, fns, _ = case(data, *args, what)
        for nm, (kern, _) in fns.items():
            ms_at[nm][f"{what} ({shape})"] = cuda_ms(kern, 3)
    print("[kernels] J / L ms at " + ", ".join(
        f"{at}: {ms_at['rc_exact_encode'][at]:.3f} / "
        f"{ms_at['rc_exact_decode'][at]:.3f}"
        for at in ms_at["rc_exact_encode"]), flush=True)
    return err, ms, work, ms_at


def phase_kernels_mtf(dev):
    """M and N against their plain step loop (mtf_ops.transform_plain)."""
    err = {"mtf_encode": 0, "mtf_decode": 0}

    def case(data, mtf1, what):
        n = len(data)
        blocks = mtf_ops.pad_blocks(to_dev(data, dev))
        enc = (lambda: mtf_kernels.encode_ranks(blocks, n, mtf1),
               lambda: mtf_ops.transform_plain(blocks, n, mtf1, False))
        ranks = hold(err, "mtf_encode", enc[0](), enc[1](),
                     f"kernel M at {what}")
        rblocks = mtf_ops.pad_blocks(ranks)
        dec = (lambda: mtf_kernels.decode_bytes(rblocks, n, mtf1),
               lambda: mtf_ops.transform_plain(rblocks, n, mtf1, True))
        out = hold(err, "mtf_decode", dec[0](), dec[1](),
                   f"kernel N at {what}")
        if out.cpu().numpy().tobytes() != data:
            fail(f"kernel N did not invert kernel M at {what}")
        ops = int((2 * ranks.to(torch.int64) + 4).sum())
        work = {"mtf_encode": (2 * n, ops), "mtf_decode": (2 * n, ops)}
        return (f"n={n}, {blocks.shape[0]} blocks, "
                f"{'MTF-1' if mtf1 else 'MTF'}",
                {"mtf_encode": enc, "mtf_decode": dec}, work)

    # one byte, a block cut inside its first 128-byte chunk, one whole
    # block, a block and a bit, three blocks and a bit; a one-byte run and
    # random bytes (ranks up to 255: the longest moves); both variants
    cases = [(textish(n, 500 + n % 97), m)
             for n in (1, 100, 32768, 32768 + 129, 3 * 32768 + 5)
             for m in (False, True)]
    cases += [(b"\x07" * 40_000, True), (b"\x07" * 40_000, False),
              (np.random.default_rng(501).integers(
                  0, 256, 50_000, np.uint8).tobytes(), True)]
    # segment edges (a block of v bytes runs as 128 segments of
    # ceil(v / 128) rounded up to a multiple of 4): under MTF-1 "aabb" then
    # "ab"... puts a swap on every segment's first byte, "aab" then "ab"...
    # a rank 1 after a rank 0 (no move); runs, all 256 values, the BWT of
    # text across a block and one byte, and short blocks of 1,023 and 1,025
    # bytes
    bwt = pipeline_stages(corpus("alice29.txt"), dev)[0][:32768 + 1]
    edges = [b"aabb" + b"ab" * 4094 + b"a", b"aab" + b"ab" * 4095,
             b"\x07" * 8193, np.random.default_rng(502).integers(
                 0, 256, 8193, np.uint8).tobytes(), bwt, bwt[:1023],
             bwt[:1025]]
    cases += [(data, m) for data in edges for m in (False, True)]
    for data, mtf1 in cases:
        case(data, mtf1, f"n={len(data)} mtf1={mtf1}")

    # held and timed at the pipeline's mtf1 stage at kennedy.xls (32
    # blocks), kernel vs plain; kernels alone at mtf alone there and at
    # grammar.lsp's pipeline stage (one block)
    ms, work, ms_at = {}, {}, {"mtf_encode": {}, "mtf_decode": {}}
    for i, (what, data, mtf1) in enumerate((
            ("kennedy.xls pipeline mtf1 stage",
             pipeline_stages(corpus("kennedy.xls"), dev)[0], True),
            ("kennedy.xls mtf", corpus("kennedy.xls"), False),
            ("grammar.lsp pipeline mtf1 stage",
             pipeline_stages(corpus("grammar.lsp"), dev)[0], True))):
        shape, fns, w = case(data, mtf1, what)
        for nm, (kern, plain) in fns.items():
            ms_at[nm][f"{what} ({shape})"] = t = cuda_ms(kern, 5)
            if i == 0:
                ms[nm] = (t, cuda_ms(plain, 1, 0))
        work = work or w
    print(f"[kernels] ok {len(cases) + 3} MTF cases (M, N) equal their plain "
          f"versions; ms kernel/plain at the kennedy.xls mtf1 stage: "
          + ", ".join(f"{nm} {a:.3f}/{b:.3f}" for nm, (a, b) in ms.items())
          + "; M / N ms at " + ", ".join(
              f"{at}: {ms_at['mtf_encode'][at]:.3f} / "
              f"{ms_at['mtf_decode'][at]:.3f}" for at in ms_at["mtf_encode"]),
          flush=True)
    return err, ms, work, ms_at


def lz_malformed(dev):
    """Containers kernel R must refuse, from grammar.lsp's v2 container at
    seg_log2 12: (what, payload, bases, sizes, n, s, expected error)."""
    data = corpus("grammar.lsp")
    blob = bytearray(slz4_ref.slz4_encode(data, seg_log2=12, parse="v2"))
    block = bytes(blob[13:])
    # segment 0's first match: its offset bytes follow the first literals
    lit = block[0] >> 4
    p = 1
    if lit == 15:
        while block[p] == 255:
            lit += 255
            p += 1
        lit += block[p]
        p += 1
    p += lit
    out = []
    for what, edit, n, code in (
            ("offset 0", {p: 0, p + 1: 0}, len(data), lz_kernels.OFFSET_ZERO),
            ("offset before the start", {p: 255, p + 1: 255}, len(data),
             lz_kernels.OFFSET_BEFORE),
            ("one byte too many", {}, len(data) - 1,
             lz_kernels.WRITE_OVERRUN),
            ("one byte short", {}, len(data) + 1, lz_kernels.BAD_LENGTH),
            ("block cut 3 bytes short", None, len(data),
             lz_kernels.READ_OVERRUN)):
        b = bytearray(block[:-3] if edit is None else block)
        for i, v in (edit or {}).items():
            b[i] = v
        sizes = torch.tensor([len(b)], dtype=torch.int64, device=dev)
        out.append((what, to_dev(bytes(b), dev),
                    torch.zeros(1, dtype=torch.int64, device=dev), sizes, n,
                    1 << 12, code))
    return out


def lz_decode_cases():
    """Containers for kernel R alone: (what, container, the bytes it holds
    (a failed segment zero), the error codes). kennedy.xls's first 32,768
    bytes at seg_log2 12 with segment 3's first match at offset 0, and a
    block whose every match copies the previous token's match (26,211
    tokens: the longest chain of pointers, the most rounds)."""
    data = corpus("kennedy.xls")[:8 << 12]
    blob = bytearray(slz4_ref.slz4_encode(data, seg_log2=12, parse="v2"))
    sizes = np.frombuffer(bytes(blob[9:41]), "<u4").astype(np.int64)
    head = 41 + int(sizes[:3].sum())
    tok = blob[head]
    p = head + 1
    lit = tok >> 4
    if lit == 15:
        while blob[p] == 255:
            lit += 255
            p += 1
        lit += blob[p]
        p += 1
    p += lit
    blob[p] = blob[p + 1] = 0
    zeroed = data[:3 << 12] + bytes(1 << 12) + data[4 << 12:]
    chain = bytearray([0x50]) + b"abcde" + bytes([4, 0])
    tokens = (131_072 - 14) // 5
    for i in range(tokens):
        chain += bytes([0x10, 97 + i % 26, 5, 0])
    chain += bytes([0x50]) + b"vwxyz"
    n = 14 + 5 * tokens
    chain_blob = (n.to_bytes(4, "little") + bytes([17]) + (1).to_bytes(
        4, "little") + len(chain).to_bytes(4, "little") + bytes(chain))
    return [("8 segments with segment 3 corrupted", bytes(blob), zeroed,
             [0, 0, 0, lz_kernels.OFFSET_ZERO, 0, 0, 0, 0]),
            ("the longest match chain", chain_blob,
             slz4_ref.decode_block(bytes(chain), n), [0])]


def v1_distance_edges():
    """Z's distance limit: a 64-byte key 5,000 bytes and then `dist` bytes
    apart, and again `dist` after the second copy (the nearest copy
    `dist` back, a farther one 5,000 more), dist 65,535 and 65,536."""
    out = []
    for dist in (65535, 65536):
        rng = np.random.default_rng(dist)
        head = rng.integers(0, 256, 64, np.uint8).tobytes()
        noise = rng.integers(0, 256, 5000 + dist, np.uint8).tobytes()
        out.append((f"a key's nearest copy {dist} back", head + noise[:4936]
                    + head + noise[4936:4872 + dist] + head + b"end", 17, True))
    return out


def phase_kernels_z(dev, shapes, edges, err, plain):
    """Z against its plain version (lz_ops.match_table_v1) at P's shapes
    and edges and at the distance limit; timed at the shapes beside its
    plain version and v2's tensor table (lz_ops.match_table). -> (Z's ms
    at each shape, its work at kennedy.xls)."""
    z_at, work = {}, None
    for i, (what, data, sl, _) in enumerate(shapes + edges
                                            + v1_distance_edges()):
        rows, lens = lz_ops.segment_rows(to_dev(data, dev), sl)
        hold(err, "lz_match_v1", lz_kernels.match_v1(rows, lens),
             plain("lz_match_v1", lambda: lz_ops.match_table_v1(rows, lens),
                   i == 0), f"kernel Z at {what}")
        if i >= len(shapes):
            continue
        shape = f"{what}: {rows.shape[0]} segments"
        z_at[shape] = cuda_ms(lambda: lz_kernels.match_v1(rows, lens), 5)
        TABLES_MS_AT.setdefault("match_table_v1", {})[shape] = cuda_ms(
            lambda: lz_ops.match_table_v1(rows, lens), 2)
        TABLES_MS_AT.setdefault("match_table (v2)", {})[shape] = cuda_ms(
            lambda: lz_ops.match_table(rows, lens), 2)
        if i == 0:
            # Z reads the rows (the last one's padding too) and lens and
            # writes lcp and cand (int64) whole
            work = (17 * rows.numel() + 8 * rows.shape[0],
                    OPS_PER_V1_POSITION * rows.numel())
    return z_at, work


def phase_kernels_k(dev, shapes, edges, err, plain):
    """K against its plain version (lz_ops.match_table) at P's shapes and
    edges, the distance limit, a 2^14-byte CT-SB superblock, ptt5 and K's
    own edges (bench/lz_edges.py: a tail position between two copies, one
    group of CAP - 1 / CAP / CAP + 1 positions, singletons, ties on 16
    bytes, keys of one home slot), and against the oracle
    (slz4_ref.match_table_v2) a segment at a time on those edges and the 11
    files; timed at P's shapes and ptt5 beside the plain version
    (phase_kernels_z times it there too). -> (K's ms at each shape, its
    work at kennedy.xls)."""
    k_at, work = {}, None
    sb = concat_corpus()[:1 << 14]
    ptt5 = [("ptt5", corpus("ptt5"), 17, True)]
    own = [(f"{nm} ({what})", lz_edges.edge(nm), 17, True)
           for nm, what in lz_edges.EDGES.items()]
    cases = (shapes + ptt5 + edges + v1_distance_edges()
             + [("a 2^14-byte CT-SB superblock", sb, 17, True)] + own)
    for i, (what, data, sl, _) in enumerate(cases):
        rows, lens = lz_ops.segment_rows(to_dev(data, dev), sl)
        got = hold(err, "lz_match_v2", lz_kernels.match_v2(rows, lens),
                   plain("lz_match_v2", lambda: lz_ops.match_table(rows, lens),
                         i == 0), f"kernel K at {what}")
        if i >= len(cases) - len(own):
            lcp, cand = (t.cpu().numpy() for t in got)
            ol, oc = slz4_ref.match_table_v2(np.frombuffer(data, np.uint8))
            if not (np.array_equal(lcp[0, :len(ol)], ol)
                    and np.array_equal(cand[0, :len(oc)], oc)):
                fail(f"kernel K at {what}: not the oracle's match_table_v2")
        if i > len(shapes):
            continue
        shape = f"{what}: {rows.shape[0]} segments"
        k_at[shape] = cuda_ms(lambda: lz_kernels.match_v2(rows, lens), 5)
        if i == 0:
            # K reads the rows (the last one's padding too) and lens and
            # writes lcp and cand (int64) whole: Z's basis
            w = rows.shape[1]
            work = (17 * rows.numel() + 8 * rows.shape[0],
                    (OPS_PER_V2_POSITION + 2 * (w - 1).bit_length())
                    * rows.numel())
    for nm in EXPECTED_SIZES["slz4"]:
        data = corpus(nm)
        rows, lens = lz_ops.segment_rows(to_dev(data, dev), 17)
        lcp, cand = (t.cpu().numpy() for t in lz_kernels.match_v2(rows, lens))
        w = rows.shape[1]
        for r in range(rows.shape[0]):
            ol, oc = slz4_ref.match_table_v2(
                np.frombuffer(data, np.uint8)[r * w:(r + 1) * w])
            if not (np.array_equal(lcp[r, :len(ol)], ol)
                    and np.array_equal(cand[r, :len(oc)], oc)):
                fail(f"kernel K at {nm}, segment {r}: not the oracle's "
                     f"match_table_v2")
    return k_at, work


def phase_kernels_lz(dev):
    """P, Q and R against their plain versions (lz_kernels.walk_plain,
    serialize_plain, decode_plain) and the payload against the v2 oracle's
    container, at the main path's shapes (P from the match table of each,
    lz_ops.match_table) and at edges; R also on malformed blocks (the same
    error code as its plain version's). Times at each shape; the plain
    versions at kennedy.xls. Then Z (phase_kernels_z), K (phase_kernels_k)
    and the encode's parts (slz4_encode_parts)."""
    err = {"lz_walk": 0, "lz_serialize": 0, "lz_decode": 0}
    rng = np.random.default_rng(601)
    text = corpus("fields.c")
    shapes = [("kennedy.xls", corpus("kennedy.xls"), 17, True),
              ("grammar.lsp", corpus("grammar.lsp"), 17, True),
              ("fields.c at seg_log2 7", text, 7, True),
              ("70,000 zero bytes", bytes(70_000), 17, True),
              ("200,000 random bytes", rng.integers(
                  0, 256, 200_000, np.uint8).tobytes(), 17, True),
              # runs of 300 to 5,000 bytes between text: P's exits 256 or
              # more past their block's end, its step bytes 255
              ("runs between text", b"".join(
                  text[k * 1000:(k + 1) * 1000] + bytes([k + 1]) * r
                  for k, r in enumerate((300, 700, 1500, 5000, 2600, 4097))),
               17, True)]
    # 300,000 random bytes at seg_log2 18: blocks past shared memory, which
    # R reads from global memory in place (as P its exits and steps: above
    # 2^17 positions, also kennedy.xls as one segment of 1,029,744)
    big = rng.integers(0, 256, 300_000, np.uint8).tobytes()
    edges = [("1 byte", b"z", 17, True), ("13 bytes", b"q" * 13, 17, True),
             ("seg_log2 0", text[:300], 0, True),
             ("seg_log2 3", text[:2000], 3, True),
             ("a tail run at seg_log2 9", text[:3000] + b"\x07" * 1200, 9,
              True),
             ("lazy=False", text, 12, False),
             ("a match of 600", b"xyz0" + b"abcdefgh" * 75 + b"tail!", 17,
              True),
             ("300,000 random bytes at seg_log2 18", big, 18, True),
             ("kennedy.xls at seg_log2 20", corpus("kennedy.xls"), 20, True)]
    ms, work, ms_at, plain_ms = {}, {}, {nm: {} for nm in err}, {}

    def plain(nm, fn, timed):
        """fn(), the plain version of kernel nm; timed: its ms by CUDA
        events into plain_ms (one call: the plain loops take seconds)."""
        if not timed:
            return fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        plain_ms[nm] = start.elapsed_time(end)
        return out

    for i, (what, data, sl, lazy) in enumerate(shapes + edges):
        n = len(data)
        rows, lens = lz_ops.segment_rows(to_dev(data, dev), sl)
        lcp, cand = lz_ops.match_table(rows, lens)
        fns = {"lz_walk": (
            lambda: lz_kernels.walk(lcp, cand, lens, lazy),
            lambda: lz_kernels.walk_plain(lcp, cand, lens, lazy))}
        tokens = hold(err, "lz_walk", fns["lz_walk"][0](),
                      plain("lz_walk", fns["lz_walk"][1], i == 0),
                      f"kernel P at {what}")
        fns["lz_serialize"] = (
            lambda: lz_kernels.serialize(rows, lens, *tokens),
            lambda: lz_kernels.serialize_plain(rows, lens, *tokens))
        payload, sizes = hold(err, "lz_serialize", fns["lz_serialize"][0](),
                              plain("lz_serialize", fns["lz_serialize"][1],
                                    i == 0), f"kernel Q at {what}")
        want = slz4_ref.slz4_encode(data, seg_log2=sl, lazy=lazy, parse="v2")
        n_segs = rows.shape[0]
        head = 9 + 4 * n_segs
        total = int(sizes.sum())
        if (want[9:head] != sizes.cpu().numpy().astype("<u4").tobytes()
                or want[head:] != payload[:total].cpu().numpy().tobytes()
                or payload.numel() != n_segs * lz_kernels.payload_bound(
                    rows.shape[1]) or payload[total:].any()):
            fail(f"kernels P and Q at {what}: not the v2 oracle's container "
                 f"in a zero-padded payload of the worst-case length")
        bases = sizes.cumsum(0) - sizes
        fns["lz_decode"] = (
            lambda: lz_kernels.decode(payload, bases, sizes, n, 1 << sl),
            lambda: lz_kernels.decode_plain(payload, bases, sizes, n, 1 << sl))
        out, codes = hold(err, "lz_decode", fns["lz_decode"][0](),
                          plain("lz_decode", fns["lz_decode"][1], i == 0),
                          f"kernel R at {what}")
        if codes.any() or out.cpu().numpy().tobytes() != data:
            fail(f"kernel R at {what} did not return the input")
        if i >= len(shapes):
            continue
        mpos, mlen, moff, count = tokens
        matches = int(count.sum())
        covered = int(mlen.to(torch.int64).sum())
        visited = rows.numel() - covered + matches
        shape = f"{what}: {n_segs} segments, {matches} matches"
        for nm, (kern, _) in fns.items():
            ms_at[nm][shape] = cuda_ms(kern, 5)
        if i == 0:
            # P reads lcp and cand (int64) where the walk goes and at the
            # position after each match (the lazy rule), and lens, and
            # writes its three [n, tcap] int32 outputs whole (zeros past
            # the count) and the counts; Q reads each input byte and a
            # match's fields once and writes the payload (its worst-case
            # length, zeros past the blocks); R reads the payload and
            # writes the bytes (each with the segments' int64 bounds)
            work = {"lz_walk": (16 * (visited + matches) + 8 * n_segs
                                + 12 * mpos.numel() + 4 * n_segs,
                                8 * (visited + matches)),
                    "lz_serialize": (n + 12 * matches + 16 * n_segs
                                     + payload.numel(), covered + total),
                    "lz_decode": (total + n + 16 * n_segs, n)}
            ms = {nm: (ms_at[nm][shape], plain_ms[nm]) for nm in fns}
    for what, payload, bases, sizes, n, s, code in lz_malformed(dev):
        out, codes = hold(err, "lz_decode",
                          lz_kernels.decode(payload, bases, sizes, n, s),
                          lz_kernels.decode_plain(payload, bases, sizes, n, s),
                          f"kernel R on a block with {what}")
        if codes.tolist() != [code] or out.any():
            fail(f"kernel R on a block with {what}: error {codes.tolist()}, "
                 f"expected {code}, and a zero segment")
    for what, blob, want, codes_want in lz_decode_cases():
        r = ByteReader(blob)
        n, sl, n_segs = r.u32(), r.u8(), r.u32()
        sizes = r.u32s(n_segs).astype(np.int64)
        payload = to_dev(r.raw(int(sizes.sum())).tobytes(), dev)
        bases = torch.from_numpy(np.cumsum(sizes) - sizes).to(dev)
        sizes = torch.from_numpy(sizes).to(dev)
        out, codes = hold(err, "lz_decode",
                          lz_kernels.decode(payload, bases, sizes, n, 1 << sl),
                          lz_kernels.decode_plain(payload, bases, sizes, n,
                                                  1 << sl),
                          f"kernel R on {what}")
        if codes.tolist() != codes_want or out.cpu().numpy().tobytes() != want:
            fail(f"kernel R on {what}: errors {codes.tolist()}, or the bytes "
                 f"differ")
        ms_at["lz_decode"][what] = cuda_ms(
            lambda: lz_kernels.decode(payload, bases, sizes, n, 1 << sl), 5)
    print(f"[kernels] ok {len(shapes) + len(edges)} CT-LZ4 cases (P, Q, R) "
          f"equal their plain versions and the v2 oracle, and 5 malformed "
          f"blocks, 8 segments with one corrupted and the longest match "
          f"chain R decodes as its plain version does; ms kernel/plain at "
          f"kennedy.xls: " + ", ".join(
              f"{nm} {a:.3f}/{b:.3f}" for nm, (a, b) in ms.items())
          + "; ms at " + "; ".join(
              f"{at}: " + " / ".join(f"{ms_at[nm][at]:.3f}" for nm in err)
              for at in ms_at["lz_walk"]) + "; R at " + ", ".join(
              f"{at} {v:.3f}" for at, v in ms_at["lz_decode"].items()
              if at not in ms_at["lz_walk"]), flush=True)
    err["lz_match_v1"] = 0
    ms_at["lz_match_v1"], work["lz_match_v1"] = phase_kernels_z(
        dev, shapes, edges, err, plain)
    ms["lz_match_v1"] = (next(iter(ms_at["lz_match_v1"].values())),
                         plain_ms["lz_match_v1"])
    print(f"[kernels] ok {len(shapes) + len(edges) + 2} CT-LZ4 v1 tables: "
          f"kernel Z equals its plain version (max_abs_err "
          f"{err['lz_match_v1']}); ms kernel/plain at kennedy.xls "
          f"{ms['lz_match_v1'][0]:.4f}/{ms['lz_match_v1'][1]:.3f}; ms at "
          + "; ".join(f"{at}: Z {v:.4f}, match_table_v1 "
                      f"{TABLES_MS_AT['match_table_v1'][at]:.3f}, v2 table "
                      f"{TABLES_MS_AT['match_table (v2)'][at]:.3f}"
                      for at, v in ms_at["lz_match_v1"].items()), flush=True)
    err["lz_match_v2"] = 0
    ms_at["lz_match_v2"], work["lz_match_v2"] = phase_kernels_k(
        dev, shapes, edges, err, plain)
    ms["lz_match_v2"] = (next(iter(ms_at["lz_match_v2"].values())),
                         plain_ms["lz_match_v2"])
    tables = TABLES_MS_AT["match_table (v2)"]
    print(f"[kernels] ok {len(shapes) + len(edges) + 4 + len(lz_edges.EDGES)} "
          f"CT-LZ4 v2 tables: kernel K equals its plain version (max_abs_err "
          f"{err['lz_match_v2']}) and the oracle's table of every segment "
          f"of the 11 files and of K's edges; ms kernel/plain at kennedy.xls "
          f"{ms['lz_match_v2'][0]:.4f}/{ms['lz_match_v2'][1]:.3f}; ms at "
          + "; ".join(f"{at}: K {v:.4f}" + (f", v2 tensor table {tables[at]:.3f}"
                                            if at in tables else "")
                      for at, v in ms_at["lz_match_v2"].items()), flush=True)
    slz4_encode_parts(dev)
    return err, ms, work, ms_at


def slz4_encode_parts(dev, reps: int = 5):
    """kennedy.xls's slz4 encode (8 segments of 2^17) in its three parts,
    each ending in a synchronize, host clock, the median of reps after a
    warm-up, by each parse: the match table (v2: kernel K; v1: kernel Z),
    the walk (kernel P), the serializer and the copies (kernel Q, then the
    sizes and the payload to the host); and the whole call (v2: compress();
    v1: lz_ops.slz4_encode(parse="v1")). v2's tensor table
    (lz_ops.match_table, K's plain version) is timed beside, the same way."""
    data = corpus("kennedy.xls")
    rows, lens = lz_ops.segment_rows(to_dev(data, dev), 17)
    names = ["match table", "walk (P)", "serializer and copies (Q)",
             "whole call"]
    tables = {"v2": lambda: lz_kernels.match_v2(rows, lens),
              "v1": lambda: lz_kernels.match_v1(rows, lens)}
    whole = {"v2": lambda: ctt.compress(data, codec="slz4", device="cuda"),
             "v1": lambda: lz_ops.slz4_encode(data, parse="v1",
                                              device="cuda")}
    parts = {}
    for parse in ("v2", "v1"):
        runs = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t = [time.perf_counter()]
            lcp, cand = tables[parse]()
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            tokens = lz_kernels.walk(lcp, cand, lens)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            payload, sizes = lz_kernels.serialize(rows, lens, *tokens)
            sizes = sizes.cpu().numpy()
            payload[:int(sizes.sum())].cpu().numpy().tobytes()
            t.append(time.perf_counter())
            whole[parse]()
            t.append(time.perf_counter())
            runs.append(np.diff(t) * 1e3)
        parts[parse] = np.median(runs[1:], axis=0)
    tensor = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        lz_ops.match_table(rows, lens)
        torch.cuda.synchronize()
        tensor.append((time.perf_counter() - t) * 1e3)
    print("[kernels] slz4 encode parts at kennedy.xls (ms, host clock, median "
          f"of {reps}): " + "; ".join(
              f"{parse} " + ", ".join(f"{nm} {v:.3f}" for nm, v in
                                      zip(names, med))
              for parse, med in parts.items())
          + f"; v2's tensor table {np.median(tensor[1:]):.3f}", flush=True)


def run_corpus(codec: str):
    """The 11 files through compress/decompress(codec, device="cuda"):
    oracle-identical, the expected sizes, round trips. -> total bytes."""
    total = raw = 0
    enc_s = dec_s = 0.0
    for name, want in EXPECTED_SIZES[codec].items():
        data = corpus(name)
        t0 = time.perf_counter()
        blob = ctt.compress(data, codec=codec, device="cuda")
        t1 = time.perf_counter()
        back = ctt.decompress(blob, codec=codec, device="cuda")
        t2 = time.perf_counter()
        ref = oracle(data, codec)
        if blob != ref:
            fail(f"{codec} {name}: container differs from the numpy oracle "
                 f"from byte {first_difference(blob, ref)}")
        if len(blob) != want:
            fail(f"{codec} {name}: {len(blob)} container bytes, expected "
                 f"{want}")
        if back != data:
            fail(f"{codec} {name}: decode did not return the input")
        total += len(blob)
        raw += len(data)
        enc_s += t1 - t0
        dec_s += t2 - t1
        print(f"[main] {codec} {name} n={len(data)} bytes={len(blob)} "
              f"ratio={len(blob) / len(data):.4f} enc_s={t1 - t0:.4f} "
              f"dec_s={t2 - t1:.4f}", flush=True)
    if total != sum(EXPECTED_SIZES[codec].values()):
        fail(f"{codec} corpus total {total} != "
             f"{sum(EXPECTED_SIZES[codec].values())}")
    return (f"11 files byte-identical, total {total} bytes (ratio "
            f"{total / raw:.4f}), enc_s={enc_s:.4f} dec_s={dec_s:.4f}")


def rcx_ratio_preset():
    for name in RATIO_FILES:
        data = corpus(name)
        k = rcx_params(len(data), mode="ratio")[0]
        t0 = time.perf_counter()
        blob = ctt.compress(data, codec="rcx", device="cuda", mode="ratio")
        t1 = time.perf_counter()
        back = ctt.decompress(blob, codec="rcx", device="cuda")
        t2 = time.perf_counter()
        ref = ctt.compress(data, codec="rcx", backend="ref", lanes=k,
                           cbits=6, wlog=0)
        if blob != ref:
            fail(f"{name} (ratio): container differs from the numpy oracle")
        if back != data:
            fail(f"{name} (ratio): decode did not return the input")
        print(f"[main] rcx {name} mode=ratio K={k} bytes={len(blob)} "
              f"ratio={len(blob) / len(data):.4f} enc_s={t1 - t0:.4f} "
              f"dec_s={t2 - t1:.4f}", flush=True)
    return f"{len(RATIO_FILES)} ratio-preset files"


def rans_default_and_wide():
    """compress()/decompress() with no codec named write and read rANS;
    one lane with more than 0xFFFF words (u32 count table) against the
    oracle."""
    data = corpus("grammar.lsp")
    blob = ctt.compress(data, device="cuda")
    if blob != ctt.compress(data, codec="rans", backend="ref"):
        fail("compress() with no codec did not write the rANS container")
    if ctt.decompress(blob, device="cuda") != data:
        fail("decompress() with no codec did not read the rANS container")
    wide = np.random.default_rng(7).integers(0, 256, 200_000,
                                             np.uint8).tobytes()
    blob = ctt.compress(wide, codec="rans", device="cuda", lanes=1)
    if not blob[4] & 0x80:
        fail("rANS at lanes=1 over 200,000 random bytes: wide bit not set")
    if blob != ctt.compress(wide, codec="rans", backend="ref", lanes=1):
        fail("wide-count rANS container differs from the numpy oracle")
    if ctt.decompress(blob, codec="rans", device="cuda") != wide:
        fail("wide-count rANS container did not round-trip")
    return "default codec is rans; wide count table oracle-identical"


def concatenated(codec: str):
    """The 11 files concatenated (2,810,784 bytes: K = 1,024, limit_log2
    17, three slots a step for CT-RC2) against the oracle, and back."""
    data = concat_corpus()
    t0 = time.perf_counter()
    blob = ctt.compress(data, codec=codec, device="cuda")
    t1 = time.perf_counter()
    back = ctt.decompress(blob, codec=codec, device="cuda")
    t2 = time.perf_counter()
    if blob != ctt.compress(data, codec=codec, backend="ref"):
        fail(f"{codec} over the concatenated corpus: container differs "
             f"from the numpy oracle")
    if len(blob) != CONCAT_BYTES[codec] or back != data:
        fail(f"{codec} over the concatenated corpus: {len(blob)} bytes (not "
             f"{CONCAT_BYTES[codec]}) or no round trip")
    print(f"[main] {codec} 11 files concatenated n={len(data)} "
          f"bytes={len(blob)} enc_s={t1 - t0:.4f} dec_s={t2 - t1:.4f}",
          flush=True)
    return f"the concatenated corpus in {len(blob)} bytes"


def resumable(name: str) -> str:
    """`name` through RCQResumableEncoder on the card (64-step chunks),
    checkpointed half-way, pickled and resumed: one-shot rcq's container
    and the oracle's, and back through decompress."""
    data = corpus(name)
    t0 = time.perf_counter()
    enc = RCQResumableEncoder(len(data))
    half = len(data) // 2 + 17
    enc.feed(data[:half])
    ckpt = pickle.dumps(enc.checkpoint())
    enc = RCQResumableEncoder.resume(pickle.loads(ckpt))
    enc.feed(data[half:])
    blob = enc.finish()
    t1 = time.perf_counter()
    if blob != ctt.compress(data, codec="rcq", device="cuda"):
        fail(f"resumable rcq {name}: container differs from one-shot rcq")
    if blob != ctt.compress(data, codec="rcq", backend="ref") \
            or len(blob) != EXPECTED_SIZES["rcq"][name]:
        fail(f"resumable rcq {name}: container differs from the oracle's")
    if ctt.decompress(blob, codec="rcq", device="cuda") != data:
        fail(f"resumable rcq {name} did not round-trip")
    print(f"[main] resume {name} n={len(data)} bytes={len(blob)} "
          f"checkpoint={len(ckpt)} bytes enc_s={t1 - t0:.4f}", flush=True)
    return name


def run_resume():
    return [f"resumable rcq over {', '.join(map(resumable, RESUME_FILES))} "
            f"equals one-shot rcq and the oracle, and round-trips"]


def synth_exact(n: int, seed: int) -> np.ndarray:
    """n bytes of bench/synth.py's stream: synth_stream(n, seed), and where
    it comes out short (a run section whose size is not a multiple of 512
    gives fewer bytes than it counts) synth_stream of the rest at the next
    seeds."""
    parts, have = [], 0
    while have < n:
        parts.append(synth_stream(n - have, seed + len(parts)))
        have += len(parts[-1])
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def oracle(data: bytes, codec: str) -> bytes:
    """The numpy oracle's container of `data` at the codec's defaults:
    backend="ref", but for slz4, whose card path writes the v2 parse, the
    oracle's v2 parse (its backend="ref" writes the v1 parse, as the JAX
    codec's does)."""
    if codec == "slz4":
        return slz4_ref.slz4_encode(data, parse="v2")
    return ctt.compress(data, codec=codec, backend="ref")


def first_difference(a: bytes, b: bytes) -> int:
    """The first byte at which a and b differ (or the shorter length)."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def oracle_stream(codec: str) -> bytes:
    """The oracle's CT-SB container of the concatenated corpus (run in a
    worker process while the card works); for slz4 its superblocks are the
    v2 oracle's (`oracle`)."""
    data = concat_corpus()
    if codec != "slz4":
        return stream.stream_encode(data, codec=codec,
                                    sb_log2=STREAM_SB_LOG2, backend="ref")
    sb = 1 << STREAM_SB_LOG2
    return stream._container(
        ctt.get_codec(codec).codec_id, STREAM_SB_LOG2,
        [oracle(data[i:i + sb], codec) for i in range(0, len(data), sb)])


def oracle_slz4_v1() -> list[bytes]:
    """The v1 oracle's containers of the 11 files (slz4's backend="ref")."""
    return [ctt.compress(corpus(nm), codec="slz4", backend="ref")
            for nm in EXPECTED_SIZES["slz4"]]


def oracle_first_superblock() -> bytes:
    """The oracle's CT-RCX container of the large stream's first superblock
    (the stream made again in a worker process)."""
    data = synth_exact(LARGE_N, SYNTH_SEED)[:1 << LARGE_SB_LOG2]
    return ctt.compress(data, codec="rcx", backend="ref")


def superblocks(blob: bytes) -> list[bytes]:
    """The containers of a CT-SB container, in order."""
    n_sb = int.from_bytes(blob[2:6], "little")
    sizes = np.frombuffer(blob, "<u4", n_sb, 6).astype(np.int64)
    ends = 6 + 4 * n_sb + np.cumsum(sizes)
    return [blob[e - s:e] for s, e in zip(sizes, ends)]


def stream_corpus(codec: str, oracle) -> int:
    """The concatenated corpus through CT-SB over `codec` at sb_log2
    STREAM_SB_LOG2 on the card: the oracle's container (oracle: its
    future), a round trip, and a range across superblock edges. -> bytes."""
    data = concat_corpus()
    t0 = time.perf_counter()
    blob = stream.stream_encode(data, codec=codec, sb_log2=STREAM_SB_LOG2)
    t1 = time.perf_counter()
    back = stream.stream_decode(blob)
    t2 = time.perf_counter()
    sb = 1 << STREAM_SB_LOG2
    lo, hi = 3 * sb - 100, 5 * sb + 100
    if back != data or stream.stream_decode_range(blob, lo, hi) != data[lo:hi]:
        fail(f"CT-SB over {codec}: no round trip, or range [{lo}, {hi}) wrong")
    if blob != oracle.result():
        fail(f"CT-SB over {codec}: a superblock differs from the oracle's")
    print(f"[main] stream {codec} n={len(data)} sb_log2={STREAM_SB_LOG2} "
          f"superblocks={len(superblocks(blob))} bytes={len(blob)} "
          f"enc_s={t1 - t0:.4f} dec_s={t2 - t1:.4f}", flush=True)
    return len(blob)


def stream_large(codec: str, data: np.ndarray, first=None) -> str:
    """The large stream through CT-SB over `codec` at the default sb_log2
    (25) on the card, host clock around encode and decode (bytes in, bytes
    out); the tail superblock's container against the oracle's, and the
    first one's where `first` (a future of it) is given."""
    marks = [{nm: len(c) for nm, c in TIMED_CALLS.items()}]
    t0 = time.perf_counter()
    blob = stream.stream_encode(data, codec=codec, sb_log2=LARGE_SB_LOG2)
    t1 = time.perf_counter()
    marks.append({nm: len(c) for nm, c in TIMED_CALLS.items()})
    back = stream.stream_decode(blob)
    t2 = time.perf_counter()
    marks.append({nm: len(c) for nm, c in TIMED_CALLS.items()})
    torch.cuda.synchronize()
    # the kernels' device time inside encode and inside decode
    kernel_s = [{nm: sum(a.elapsed_time(b) for a, b in c[lo[nm]:hi[nm]]) / 1e3
                 for nm, c in TIMED_CALLS.items() if hi[nm] > lo[nm]}
                for lo, hi in zip(marks, marks[1:])]
    if not np.array_equal(np.frombuffer(back, np.uint8), data):
        fail(f"CT-SB over {codec} at {len(data)} bytes did not round-trip")
    del back
    sbs = superblocks(blob)
    sb = 1 << LARGE_SB_LOG2
    if len(sbs) != -(-len(data) // sb):
        fail(f"CT-SB over {codec}: {len(sbs)} superblocks")
    tail = data[(len(sbs) - 1) * sb:]
    if sbs[-1] != ctt.compress(tail, codec=codec, backend="ref"):
        fail(f"CT-SB over {codec}: the tail superblock ({len(tail)} bytes) "
             f"differs from the oracle's")
    if first is not None and sbs[0] != first.result():
        fail(f"CT-SB over {codec}: the first superblock differs from the "
             f"oracle's")
    gb = len(data) / 1e9
    print(f"[main] stream large {codec} n={len(data)} superblocks={len(sbs)} "
          f"(last {len(tail)} bytes) bytes={len(blob)} "
          f"ratio={len(blob) / len(data):.4f} enc_s={t1 - t0:.3f} "
          f"dec_s={t2 - t1:.3f} enc_GBps={gb / (t1 - t0):.4f} "
          f"dec_GBps={gb / (t2 - t1):.4f}; kernel s in encode "
          + ", ".join(f"{nm} {t:.4f}" for nm, t in kernel_s[0].items())
          + "; in decode "
          + ", ".join(f"{nm} {t:.4f}" for nm, t in kernel_s[1].items()),
          flush=True)
    return (f"{codec}: enc {t1 - t0:.3f} s, dec {t2 - t1:.3f} s"
            + (", first and tail superblocks" if first else ", tail superblock")
            + " equal the oracle's")


def run_stream(oracles):
    """Every ported codec through CT-SB over the concatenated corpus, then
    the large stream over rcx and rans."""
    total = sum(stream_corpus(codec, oracles[codec]) for codec in STREAM_CODECS)
    notes = [f"{len(STREAM_CODECS)} codecs through CT-SB over the "
             f"concatenated corpus equal the oracle ({total} bytes in all)"]
    t0 = time.perf_counter()
    data = synth_exact(LARGE_N, SYNTH_SEED)
    print(f"[main] stream large input: synth_stream({LARGE_N}, "
          f"{SYNTH_SEED}) made in {time.perf_counter() - t0:.1f} s",
          flush=True)
    notes += [stream_large("rcx", data, oracles["large rcx"]),
              stream_large("rans", data)]
    return notes


def start_oracles(pool):
    """The oracle containers the stream path is held to, computed in
    worker processes from the start: {codec or "large rcx": future}."""
    futures = {codec: pool.submit(oracle_stream, codec)
               for codec in STREAM_CODECS}
    futures["large rcx"] = pool.submit(oracle_first_superblock)
    futures["slz4 concatenated"] = pool.submit(oracle, concat_corpus(), "slz4")
    futures["slz4 v1"] = pool.submit(oracle_slz4_v1)
    return futures


def slz4_whole_inputs(oracles):
    """The 11 files concatenated (2,810,784 bytes, 22 segments of 2^17:
    the C1 row, where the JAX package's serializer wraps) against the v2
    oracle's container, and back."""
    data = concat_corpus()
    t0 = time.perf_counter()
    blob = ctt.compress(data, codec="slz4", device="cuda")
    t1 = time.perf_counter()
    back = ctt.decompress(blob, codec="slz4", device="cuda")
    t2 = time.perf_counter()
    ref = oracles["slz4 concatenated"].result()
    if blob != ref:
        fail(f"slz4 over the concatenated corpus: container differs from the "
             f"v2 oracle's from byte {first_difference(blob, ref)}")
    if len(blob) != SLZ4_CONCAT_BYTES or back != data:
        fail(f"slz4 over the concatenated corpus: {len(blob)} bytes (not "
             f"{SLZ4_CONCAT_BYTES}) or no round trip")
    print(f"[main] slz4 11 files concatenated n={len(data)} "
          f"bytes={len(blob)} enc_s={t1 - t0:.4f} dec_s={t2 - t1:.4f}",
          flush=True)
    return (f"the concatenated corpus in {len(blob)} bytes (the v2 "
            f"oracle's)")


def slz4_v1_files(oracles):
    """The v1 parse on the card: the 11 files through
    lz_ops.slz4_encode(parse="v1", device="cuda") (kernels Z, P and Q),
    each container the v1 oracle's (slz4's backend="ref", computed in a
    worker process), 1,140,737 bytes in all, each decoded through R."""
    v1 = oracles["slz4 v1"].result()
    enc_s = dec_s = 0.0
    for name, want in zip(EXPECTED_SIZES["slz4"], v1):
        data = corpus(name)
        t0 = time.perf_counter()
        blob = lz_ops.slz4_encode(data, parse="v1", device="cuda")
        t1 = time.perf_counter()
        back = ctt.decompress(blob, codec="slz4", device="cuda")
        dec_s += time.perf_counter() - t1
        enc_s += t1 - t0
        if blob != want:
            fail(f"slz4 v1 on the card, {name}: container differs from the "
                 f"v1 oracle's from byte {first_difference(blob, want)}")
        if back != data:
            fail(f"slz4 v1 on the card, {name}: no round trip")
    if sum(map(len, v1)) != SLZ4_V1_BYTES:
        fail(f"slz4: the v1 oracle wrote {sum(map(len, v1))} bytes, not "
             f"{SLZ4_V1_BYTES}")
    print(f"[main] slz4 v1 on the card: the 11 files in {SLZ4_V1_BYTES} "
          f"bytes (the v1 oracle's) enc_s={enc_s:.4f} dec_s={dec_s:.4f}",
          flush=True)
    return (f"the 11 files' v1 containers written on the card are the v1 "
            f"oracle's ({SLZ4_V1_BYTES} bytes) and decode")


EXTRAS = {"rcx": lambda _: rcx_ratio_preset(), "rcq": None,
          "rans": lambda _: rans_default_and_wide(), "huffman": None,
          "static_range": lambda _: concatenated("static_range"),
          "adaptive_range": lambda _: concatenated("adaptive_range"),
          "blocksort": None, "mtf": None, "mtf1": None, "rle0": None,
          "pipeline": None, "slz4": slz4_whole_inputs, "ase": None,
          "adaptive_o1": None, "adaptive_rans": None}


def phase_main(codec: str, oracles):
    """One path (a codec's, "resume" or "stream"), with its kernels' launch
    counts set to 0 just before and read just after, and every call of
    their wrappers recorded; then each recorded call is timed again with
    CUDA events (3 reps after a warm-up) and the times are summed a kernel.
    The stream path's calls are timed where they run instead (CUDA events
    around each call, one sample): their inputs (a 2^25-byte superblock's
    event grid is 268 MB) are not kept for timing again.
    -> ({kernel: launches}, {kernel: main_ms})."""
    in_place = codec == "stream"
    calls = {nm: [] for nm in PATH_KERNELS[codec]}
    if in_place:
        TIMED_CALLS.clear()
        TIMED_CALLS.update(calls)
    wrapped = {}
    for nm in PATH_KERNELS[codec]:
        mod, counter, attr = COUNTERS[nm]
        fn = wrapped[nm] = getattr(mod, attr)

        def record(*a, _fn=fn, _calls=calls[nm], **kw):
            if not in_place:
                _calls.append((_fn, a, kw))
                return _fn(*a, **kw)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = _fn(*a, **kw)
            ev[1].record()
            _calls.append(ev)
            return out

        setattr(mod, attr, record)
        setattr(mod, counter, 0)
    try:
        if codec == "resume":
            notes = run_resume()
        elif codec == "slz4_v1":
            notes = [slz4_v1_files(oracles)]
        elif codec == "stream":
            notes = run_stream(oracles)
        else:
            notes = [run_corpus(codec)]
            if EXTRAS[codec]:
                notes.append(EXTRAS[codec](oracles))
        launches = {nm: getattr(*COUNTERS[nm][:2]) for nm in PATH_KERNELS[codec]}
    finally:
        for nm, fn in wrapped.items():
            setattr(COUNTERS[nm][0], COUNTERS[nm][2], fn)
    idle = [nm for nm, c in launches.items() if c == 0]
    if idle:
        fail(f"kernels never launched on the {codec} path: {idle}")
    if any(len(calls[nm]) != c for nm, c in launches.items()):
        fail(f"{codec}: recorded calls {[len(c) for c in calls.values()]} "
             f"!= launches {launches}")
    torch.cuda.synchronize()
    if in_place:
        main_ms = {nm: sum(start.elapsed_time(end) for start, end in calls[nm])
                   for nm in calls}
    else:
        main_ms = {nm: sum(cuda_ms(lambda: fn(*a, **kw), 3)
                           for fn, a, kw in calls[nm]) for nm in calls}
    print(f"[main] ok {codec}: {'; '.join(notes)}; launches {launches}; "
          f"kernel ms summed over them "
          + ", ".join(f"{nm} {v:.3f}" for nm, v in main_ms.items()),
          flush=True)
    return launches, main_ms


KERNELS = [
    ("rcx_encode", "cpprcoder_tpu_torch/csrc/rcx_encode.cu",
     "cpprcoder_tpu/ops/rcx_pallas.py:163"),
    ("expand", "cpprcoder_tpu_torch/csrc/expand.cu",
     "cpprcoder_tpu/ops/expand_pallas.py:55"),
    ("rcx_decode", "cpprcoder_tpu_torch/csrc/rcx_decode.cu",
     "cpprcoder_tpu/ops/rcx_pallas.py:374"),
    ("rcq_encode", "cpprcoder_tpu_torch/csrc/rcq_encode.cu",
     "cpprcoder_tpu/ops/rcq_pallas.py:324"),
    ("rcq_decode", "cpprcoder_tpu_torch/csrc/rcq_decode.cu",
     "cpprcoder_tpu/ops/rcq_pallas.py:151"),
    ("rans_encode", "cpprcoder_tpu_torch/csrc/rans_encode.cu",
     "cpprcoder_tpu/ops/rans_pallas.py:76"),
    ("rans_decode", "cpprcoder_tpu_torch/csrc/rans_decode.cu",
     "cpprcoder_tpu/ops/rans_pallas.py:225"),
    ("huffman_encode", "cpprcoder_tpu_torch/csrc/huffman_encode.cu",
     "cpprcoder_tpu/ops/huffman_pallas.py:79"),
    ("huffman_decode", "cpprcoder_tpu_torch/csrc/huffman_decode.cu",
     "cpprcoder_tpu/ops/huffman_pallas.py:220"),
]
# kernels for the JAX package's lax.scan loops (no Pallas kernel): the
# scan each replaces
SCAN_KERNELS = [
    ("rc_exact_encode", "cpprcoder_tpu_torch/csrc/rc_exact.cu",
     "cpprcoder_tpu/ops/range_ops.py:94"),
    ("rc_exact_decode", "cpprcoder_tpu_torch/csrc/rc_exact.cu",
     "cpprcoder_tpu/ops/range_ops.py:314"),
    ("mtf_encode", "cpprcoder_tpu_torch/csrc/mtf.cu",
     "cpprcoder_tpu/ops/mtf_ops.py:45"),
    ("mtf_decode", "cpprcoder_tpu_torch/csrc/mtf.cu",
     "cpprcoder_tpu/ops/mtf_ops.py:64"),
    ("rcq_encode_chunk", "cpprcoder_tpu_torch/csrc/rcq_encode.cu",
     "cpprcoder_tpu/codecs/resume.py:44"),
    # CT-LZ4: the v2 match table (K, the JAX package's XLA code), the v1
    # table (Z), the walk (P) and serializer (Q), and the decode (R)
    ("lz_match_v2", "cpprcoder_tpu_torch/csrc/lz_match_v2.cu",
     "cpprcoder_tpu/ops/lz_ops.py:589"),
    ("lz_match_v1", "cpprcoder_tpu_torch/csrc/lz_match.cu",
     "cpprcoder_tpu/ops/lz_ops.py:81"),
    ("lz_walk", "cpprcoder_tpu_torch/csrc/lz_encode.cu",
     "cpprcoder_tpu/ops/lz_ops.py:644"),
    ("lz_serialize", "cpprcoder_tpu_torch/csrc/lz_encode.cu",
     "cpprcoder_tpu/ops/lz_ops.py:396"),
    ("lz_decode", "cpprcoder_tpu_torch/csrc/lz_decode.cu",
     "cpprcoder_tpu/ops/lz_ops.py:756"),
    # CT-ASE1 (S, T) and CT-RC3 (U, V)
    ("ase_encode", "cpprcoder_tpu_torch/csrc/ase.cu",
     "cpprcoder_tpu/ops/ase_ops.py:47"),
    ("ase_decode", "cpprcoder_tpu_torch/csrc/ase.cu",
     "cpprcoder_tpu/ops/ase_ops.py:103"),
    ("o1_encode", "cpprcoder_tpu_torch/csrc/o1_encode.cu",
     "cpprcoder_tpu/ops/o1_ops.py:132"),
    ("o1_decode", "cpprcoder_tpu_torch/csrc/o1_decode.cu",
     "cpprcoder_tpu/ops/o1_ops.py:169"),
    # CT-ANS2: W the model (pass A), X the coder (pass C, pass B folded
    # in), Y the decode
    ("ans2_model", "cpprcoder_tpu_torch/csrc/ans2_encode.cu",
     "cpprcoder_tpu/ops/ans2_ops.py:99"),
    ("ans2_encode", "cpprcoder_tpu_torch/csrc/ans2_encode.cu",
     "cpprcoder_tpu/ops/ans2_ops.py:153"),
    ("ans2_decode", "cpprcoder_tpu_torch/csrc/ans2_decode.cu",
     "cpprcoder_tpu/ops/ans2_ops.py:183"),
]


# the tooling phase: the CLI's stages and the files it runs them on
TOOL_STAGES = ["blocksort", "mtf1", "rle0", "adaptive_range"]
TOOL_BENCH = ("kennedy.xls", "grammar.lsp")


def cli_start(*args):
    """python -m cpprcoder_tpu_torch.cli ARGS in a process of its own, on
    the card (no --device)."""
    return subprocess.Popen(
        [sys.executable, "-m", "cpprcoder_tpu_torch.cli", *args], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def cli_wait(proc, what: str) -> tuple[str, str]:
    """-> its (stdout, stderr); fails unless it exits 0 within 300 s."""
    try:
        out, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"CLI {what}: no exit within 300 s")
    if proc.returncode != 0:
        fail(f"CLI {what}: exit {proc.returncode}: {err[-2000:]}")
    return out, err


def phase_ms(rep: dict) -> str:
    return ", ".join(f"{nm} {row['wall_s'] * 1e3:.3f} ms"
                     for nm, row in rep.items())


def phase_tooling(smi_line: str) -> str:
    """The port's tooling on the card: the CLI as processes of their own
    (compress and decompress of kennedy.xls by rans with --profile and
    --shadow, byte-compared; a --stages pipeline on grammar.lsp; bench's
    JSON rows, which must round-trip and equal the codec paths' container
    sizes), the profile report's phases at kennedy.xls (adaptive_range
    encode, rcq and rcx decode), and the host library's four other entry
    points, whose containers must equal the card's on the 11 files."""
    work = os.path.join(ROOT, "build", "tooling")
    os.makedirs(work, exist_ok=True)
    src = {nm: os.path.join(ROOT, "data", nm) for nm in TOOL_BENCH}
    at = {nm: os.path.join(work, nm) for nm in
          ("k.ct", "k.out", "g.ct", "g.out")}
    procs = [cli_start("compress", "-c", "rans", "--profile", "--shadow",
                       src["kennedy.xls"], at["k.ct"]),
             cli_start("compress", src["grammar.lsp"], at["g.ct"],
                       "--stages", *TOOL_STAGES),
             cli_start("bench", "-c", "rans", "rcx", "--files", *TOOL_BENCH,
                       "--json")]
    _, err = cli_wait(procs[0], "compress -c rans --profile --shadow")
    if "| phase |" not in err:
        fail(f"CLI compress --profile printed no report: {err[-500:]}")
    cli_wait(procs[1], "compress --stages")
    bench_out, _ = cli_wait(procs[2], "bench --json")
    procs = [cli_start("decompress", "-c", "rans", "--profile", at["k.ct"],
                       at["k.out"]),
             cli_start("decompress", "--stages", at["g.ct"], at["g.out"])]
    cli_wait(procs[0], "decompress -c rans --profile")
    cli_wait(procs[1], "decompress --stages")
    kennedy, grammar = corpus("kennedy.xls"), corpus("grammar.lsp")
    with open(at["k.ct"], "rb") as f:
        k_blob = f.read()
    with open(at["g.ct"], "rb") as f:
        g_blob = f.read()
    if k_blob != ctt.compress(kennedy, codec="rans", device="cuda") \
            or k_blob != oracle(kennedy, "rans"):
        fail("CLI compress -c rans: not the codec path's container")
    if g_blob != ctt.compress(grammar, codec="pipeline", stages=TOOL_STAGES,
                              backend="ref"):
        fail("CLI compress --stages: not the oracle's container")
    for nm, data in (("k.out", kennedy), ("g.out", grammar)):
        with open(at[nm], "rb") as f:
            if f.read() != data:
                fail(f"CLI decompress: {nm} is not the input")
    rows = [json.loads(line) for line in bench_out.splitlines()
            if line.startswith("{")]
    if [r["codec"] for r in rows] != ["rans", "rcx"]:
        fail(f"CLI bench: rows {[r.get('codec') for r in rows]}")
    for r in rows:
        for f in r["files"]:
            want = len(ctt.compress(corpus(f["file"]), codec=r["codec"],
                                    device="cuda"))
            if not f["roundtrip_ok"] or f["compressed"] != want:
                fail(f"CLI bench {r['codec']} {f['file']}: {f}")
    # the profile report's phases, in this process
    profiling.enable()
    reports = {}
    try:
        for what, fn in (
                ("adaptive_range encode", lambda: ctt.compress(
                    kennedy, codec="adaptive_range", device="cuda")),
                ("rcq decode", lambda b=ctt.compress(kennedy, codec="rcq",
                                                     device="cuda"):
                 ctt.decompress(b, codec="rcq", device="cuda")),
                ("rcx decode", lambda b=ctt.compress(kennedy, codec="rcx",
                                                     device="cuda"):
                 ctt.decompress(b, codec="rcx", device="cuda"))):
            fn()    # warm
            profiling.reset()
            fn()
            reports[what] = profiling.report()
    finally:
        profiling.disable()
        profiling.reset()
    if set(reports["adaptive_range encode"]) != {
            "enc.scan", "enc.materialize", "enc.assemble"} or any(
            set(reports[w]) != {"dec.rows", "dec.scan", "dec.fetch"}
            for w in ("rcq decode", "rcx decode")):
        fail(f"profile phases: {reports}")
    print(f"[tooling] profile at kennedy.xls ({smi_line}): "
          + "; ".join(f"{w}: {phase_ms(r)}" for w, r in reports.items()),
          flush=True)
    # the host library's entry points against the card's containers
    files = list(EXPECTED_SIZES["rcx"])
    for nm in files:
        data = corpus(nm)
        n = len(data)
        k = pick_lanes(n)
        kq, inc_q, cl_q = rcq_params(n)
        kx, inc_x, cl_x, cb_x = rcx_params(n)
        for codec, blob, dec in (
                ("static_range", ctrc.static_encode(data, k),
                 ctrc.static_decode),
                ("adaptive_range", ctrc.adaptive_encode(
                    data, k, *adaptive_params_for(k)), ctrc.adaptive_decode),
                ("rcq", ctrc.rcq_encode(data, kq, inc_q, cl_q),
                 ctrc.rcq_decode),
                ("rcx", ctrc.rcx_encode(data, kx, inc_x, cl_x, cb_x),
                 ctrc.rcx_decode)):
            if blob != ctt.compress(data, codec=codec, device="cuda") \
                    or dec(blob) != data:
                fail(f"native {codec} at {nm}: not the card's container, "
                     f"or no round trip")
    return (f"CLI compress/decompress (rans --profile --shadow at "
            f"kennedy.xls, --stages at grammar.lsp) and bench (rans, rcx) "
            f"on the card; profile phases; native static/adaptive/rcq/rcx "
            f"equal the card's containers on {len(files)} files")


# the parallel phase: the kernels of the sharded paths (parallel/), whose
# launches (and their forms') inside the sharded calls of the spawned ranks
# and torchrun's processes count under launches_by_path["parallel"]
PARALLEL_KERNELS = [nm for nm in dryrun.COUNTERS if nm not in dryrun.FORMS]
# the torchrun launches: (processes, bytes; None: the default 2^24)
TORCHRUN = ((1, None), (2, 1 << 20))
# a stepped decode timed a segment of windows at a time behind a spin of
# the card (torch.cuda._sleep cycles a launch: about 0.3 ms, some times the
# wrapper's host time), so that its launches queue up before the card
# reaches them; where the card caught up with the host (a slow host), the
# run is timed again with the spin doubled, up to SPIN_TRIES runs
SEGMENT = 64
SPIN_A_LAUNCH = 600_000
SPIN_TRIES = 4


def stepped_run(words, lane_len, lane_n: int, steps: int, window: int,
                launch, plain, cbits: int, check: bool,
                spin: int = SPIN_A_LAUNCH):
    """A lane-sharded decode of one stream with lane_n ranks simulated in
    this process: each window, every rank's stepped launch, held (where
    `check`) launch by launch to the plain version from the same state
    (its symbols and the state after it: lane state, counts, contexts),
    then the ranks' symbols joined as the exchange would. Unchecked, rank
    0's launches are timed: the windows go SEGMENT at a time behind a spin
    of the card (`spin` cycles a launch), each launch between two events, so that the events see
    the kernel and not the wrapper's host work, whose time is taken apart.
    -> (symbols [steps, K], largest difference, (rank 0's launches, their
    device ms summed, their wrappers' host ms summed, whether the card was
    still spinning when each segment was queued))."""
    k = words.shape[1]
    ko = k // lane_n
    ws = [words[:, r * ko:(r + 1) * ko].contiguous()[None]
          for r in range(lane_n)]
    ll = lane_len[None].contiguous()
    states = [rcx_ops.decode_state(w, k, cbits) for w in ws]
    xs = torch.empty((1, 0, k), dtype=torch.uint8, device=words.device)
    outs, err = [], 0
    pairs, host_ms, queued = [], 0.0, True
    windows = list(range(0, steps, window))
    for s0 in range(0, len(windows), SEGMENT):
        seg = windows[s0:s0 + SEGMENT]
        if not check:
            torch.cuda.synchronize()
            torch.cuda._sleep(spin * len(seg) * lane_n)
            spun = torch.cuda.Event()
            spun.record()
        for t0 in seg:
            n = min(window, steps - t0)
            got = []
            for r in range(lane_n):
                if check:
                    mirror = tuple(t.clone() for t in states[r])
                    want = plain(ws[r], ll, mirror, xs, r * ko, t0, n)
                if r == 0 and not check:
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    h0 = time.perf_counter()
                    o = launch(ws[r], ll, states[r], xs, r * ko, t0, n)
                    host_ms += (time.perf_counter() - h0) * 1e3
                    b.record()
                    pairs.append((a, b))
                else:
                    o = launch(ws[r], ll, states[r], xs, r * ko, t0, n)
                if check:
                    err = max(err, max_err(o, want), *(
                        max_err(a, b) for a, b in zip(states[r], mirror)))
                got.append(o)
            xs = torch.cat(got, dim=2).contiguous()
            outs.append(xs[0])
        if not check:
            queued = queued and not spun.query()
    torch.cuda.synchronize()
    ms = sum(a.elapsed_time(b) for a, b in pairs)
    return torch.cat(outs), err, (len(pairs), ms, host_ms, queued)


def parallel_forms(dev):
    """The lane-range forms of A, D and J and the stepped lane-range forms
    of C and E, each held to its plain version (exact) at K_local below and
    at 1,024 lanes and above (A and C's one-CTA, global-model and cluster
    instantiations), the stepped ones launch by launch with their state;
    then timed at kennedy.xls's shapes beside the one-shot kernel (the
    plain versions' times there are phase 3's). -> ({kernel: largest
    difference}, {kernel: its form's numbers})."""
    kennedy = corpus("kennedy.xls")
    err = dict.fromkeys(PARALLEL_KERNELS, 0)

    def held(nm, got, want):
        err[nm] = max(err[nm], max_err(got, want))

    def chunked(data, k):
        n, x = len(data), to_dev(data, dev)
        stride = -(-n // k)
        return (layout.pad2d_chunked(x, k, stride),
                layout.lane_lengths(n, k, stride, dev), stride)

    # A: (K, cbits, lane ranks, rank, steps)
    for k, cb, lane_n, r, steps in ((512, 4, 2, 1, 150), (256, 8, 2, 0, 90),
                                    (2048, 4, 2, 1, 100),
                                    (4096, 8, 4, 2, 40)):
        x2d, ll, _ = chunked(kennedy[:k * steps - k // 3], k)
        ko = k // lane_n
        got = rcx_kernels.encode_events_range(x2d, ll, r * ko, ko, 16,
                                              1 << 16, cb, 0)
        held("rcx_encode", got, rcx_ops.encode_events_plain(
            x2d, ll, 16, 1 << 16, cb, 0)[:, r * ko:(r + 1) * ko])
        held("rcx_encode", got, rcx_kernels.encode_events(
            x2d, ll, 16, 1 << 16, cb, 0)[:, r * ko:(r + 1) * ko])
    # D and J: (K, lane ranks, rank, steps)
    for k, lane_n, r, steps in ((512, 2, 1, 150), (2048, 2, 0, 100),
                                (8192, 4, 3, 30)):
        n, _, x2d, ll = interleaved_inputs(kennedy[:k * steps - 5], k, dev)
        ko = k // lane_n
        got = rcq_kernels.encode_events_range(x2d, ll, r * ko, ko, 24,
                                              1 << 16)
        held("rcq_encode", got, rcx_ops.encode_events_plain(
            x2d, ll, 24, 1 << 16, 0, 0, rcq_ops.ROUNDS)[:, r * ko:(r + 1) * ko])
    for k, lane_n, r, steps, limit in ((512, 2, 1, 150, 16),
                                       (2048, 2, 1, 100, 16),
                                       (4096, 2, 0, 60, 16),
                                       (1024, 2, 0, 100, 17)):
        n, _, x2d, ll = interleaved_inputs(kennedy[:k * steps - 7], k, dev)
        ko = k // lane_n
        got = range_kernels.encode_events_range(x2d, ll, r * ko, ko, None,
                                                24, limit)
        held("rc_exact_encode", got, range_ops.encode_events_plain(
            x2d, ll, None, 24, limit)[:, r * ko:(r + 1) * ko])

    def rcx_words(data, k, cb, wlog):
        x2d, ll, stride = chunked(data, k)
        ev = rcx_kernels.encode_events(x2d, ll, 16, 1 << 16, cb, wlog)
        return layout.decode_words(*expand.materialize_rows(ev)), ll, stride

    def rcq_words(data, k):
        n, stride, x2d, ll = interleaved_inputs(data, k, dev)
        ev = rcq_kernels.encode_events(x2d, ll, 24, 1 << 16)
        return layout.decode_words(*expand.materialize_rows(ev)), ll, stride

    def c_launch(cb, wlog):
        return lambda w, ll, st, xs, l0, t0, n: rcx_kernels.decode_steps(
            w, ll, st, xs, l0, t0, n, 16, 1 << 16, cb, wlog)

    def c_plain(cb):
        return lambda w, ll, st, xs, l0, t0, n: rcx_ops.decode_steps_plain(
            w, ll, st, xs, l0, t0, n, 16, 1 << 16, cb)

    e_launch = (lambda w, ll, st, xs, l0, t0, n: rcq_kernels.decode_steps(
        w, ll, st, xs, l0, t0, 24, 1 << 16))
    e_plain = (lambda w, ll, st, xs, l0, t0, n: rcx_ops.decode_steps_plain(
        w, ll, st, xs, l0, t0, 1, 24, 1 << 16, 0, rcq_ops.ROUNDS))
    # C: (K, cbits, wlog, lane ranks, steps)
    for k, cb, wlog, lane_n, steps in ((512, 4, 0, 2, 80), (256, 8, 2, 2, 60),
                                       (2048, 4, 0, 2, 40),
                                       (4096, 8, 1, 4, 24)):
        data = kennedy[:k * steps - k // 3]
        words, ll, stride = rcx_words(data, k, cb, wlog)
        sym, e, _ = stepped_run(words, ll, lane_n, stride, 1 << wlog,
                                c_launch(cb, wlog), c_plain(cb), cb, True)
        err["rcx_decode"] = max(err["rcx_decode"], e)
        if sym.T.reshape(-1)[:len(data)].cpu().numpy().tobytes() != data:
            fail(f"stepped C at K={k} cbits={cb} wlog={wlog}: not the input")
    # E: (K, lane ranks, steps)
    for k, lane_n, steps in ((256, 2, 80), (2048, 2, 40), (8192, 4, 12)):
        data = kennedy[:k * steps - 3]
        words, ll, stride = rcq_words(data, k)
        sym, e, _ = stepped_run(words, ll, lane_n, stride, 1, e_launch,
                                e_plain, 0, True)
        err["rcq_decode"] = max(err["rcq_decode"], e)
        if sym.reshape(-1)[:len(data)].cpu().numpy().tobytes() != data:
            fail(f"stepped E at K={k}: not the input")

    # times at kennedy.xls's shapes, lane = 2, rank 0's lanes
    n = len(kennedy)
    forms = {}
    kx, inc_x, _, cb_x = rcx_params(n)
    x2d, ll, stride = chunked(kennedy, kx)
    ko = kx // 2
    forms["rcx_encode"] = {
        "form": "lane-range", "k": kx, "ko": ko,
        "ms": cuda_ms(lambda: rcx_kernels.encode_events_range(
            x2d, ll, 0, ko, inc_x, 1 << 16, cb_x, 0), 3),
        "one_shot_ms": cuda_ms(lambda: rcx_kernels.encode_events(
            x2d, ll, inc_x, 1 << 16, cb_x, 0), 3)}
    kq, inc_q, _ = rcq_params(n)
    _, _, q2d, qll = interleaved_inputs(kennedy, kq, dev)
    forms["rcq_encode"] = {
        "form": "lane-range", "k": kq, "ko": kq // 2,
        "ms": cuda_ms(lambda: rcq_kernels.encode_events_range(
            q2d, qll, 0, kq // 2, inc_q, 1 << 16), 3),
        "one_shot_ms": cuda_ms(lambda: rcq_kernels.encode_events(
            q2d, qll, inc_q, 1 << 16), 3)}
    k2 = pick_lanes(n)
    inc2, lim2 = adaptive_params_for(k2)
    _, _, j2d, jll = interleaved_inputs(kennedy, k2, dev)
    forms["rc_exact_encode"] = {
        "form": "lane-range", "k": k2, "ko": k2 // 2,
        "ms": cuda_ms(lambda: range_kernels.encode_events_range(
            j2d, jll, 0, k2 // 2, None, inc2, lim2), 3),
        "one_shot_ms": cuda_ms(lambda: range_kernels.encode_events(
            j2d, jll, None, inc2, lim2), 3)}
    # the stepped decodes: every launch of both ranks, the exchange a
    # concatenation on the card (no collective: the ranks' runs time it);
    # ms is one rank's launches' device time summed, host_ms its wrappers'
    # host time, against the one-shot decode; timed again with a longer
    # spin where the card caught up with the host (`tries`)
    def stepped_timed(words, ll, steps, launch, plain, cbits, k,
                      one_shot_ms):
        spin = SPIN_A_LAUNCH
        for tries in range(1, SPIN_TRIES + 1):
            sym, _, (n_l, ms, host_ms, queued) = stepped_run(
                words, ll, 2, steps, 1, launch, plain, cbits, False, spin)
            if queued:
                break
            spin *= 2
        return sym, {"form": "stepped lane-range", "k": k, "ko": k // 2,
                     "timed_launches": n_l, "ms": ms, "host_ms": host_ms,
                     "device_us_a_launch": ms / n_l * 1e3,
                     "host_us_a_launch": host_ms / n_l * 1e3,
                     "queued": queued, "tries": tries,
                     "one_shot_ms": one_shot_ms}

    words, ll, stride = rcx_words(kennedy, kx, cb_x, 0)
    sym, forms["rcx_decode"] = stepped_timed(
        words, ll, stride, c_launch(cb_x, 0), c_plain(cb_x), cb_x, kx,
        cuda_ms(lambda: rcx_kernels.decode_symbols(
            words, ll, n, stride, inc_x, 1 << 16, cb_x, 0), 3))
    if sym.T.reshape(-1)[:n].cpu().numpy().tobytes() != kennedy:
        fail("stepped C at kennedy.xls: not the input")
    words, qll2, qstride = rcq_words(kennedy, kq)
    sym, forms["rcq_decode"] = stepped_timed(
        words, qll2, qstride, e_launch, e_plain, 0, kq,
        cuda_ms(lambda: rcq_kernels.decode_symbols(
            words, qll2, n, qstride, inc_q, 1 << 16), 3))
    if sym.reshape(-1)[:n].cpu().numpy().tobytes() != kennedy:
        fail("stepped E at kennedy.xls: not the input")
    for nm, f in forms.items():
        f["max_abs_err"] = err[nm]
    return err, forms


def torchrun_start(nproc: int, nbytes: int | None, backend: str):
    """The launch module under torchrun --standalone, started: -> (its
    process, nproc)."""
    exe = shutil.which("torchrun")
    cmd = ([exe] if exe else [sys.executable, "-m", "torch.distributed.run"])
    cmd += ["--standalone", "--nproc-per-node", str(nproc), "-m",
            "cpprcoder_tpu_torch.parallel.launch"]
    cmd += ([str(nbytes)] if nbytes else []) + ["--backend", backend]
    return subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), nproc


def torchrun_wait(run) -> dict:
    """-> the started launch's JSON line; fails unless it exits 0 within
    300 s and round-trips."""
    proc, nproc = run
    try:
        out, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"torchrun x{nproc}: no exit within 300 s")
    rows = [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]
    if proc.returncode != 0 or len(rows) != 1 or not rows[0].get(
            "roundtrip_ok"):
        fail(f"torchrun x{nproc}: exit {proc.returncode}, {rows}, "
             f"{err[-2000:]}")
    return rows[0]


def parallel_oracle(codec: str) -> bytes:
    """kennedy.xls's oracle container at the sharded path's parameters
    (rcx at wlog 0), for the parallel phase's workers."""
    data = corpus("kennedy.xls")
    n = len(data)
    if codec == "rcx":
        k, inc, cl, cb = rcx_params(n)
        return rcx_ref.rcx_encode(data, lanes=k, inc=inc, climit_log2=cl,
                                  cbits=cb, wlog=0)
    if codec == "rcq":
        k, inc, cl = rcq_params(n)
        return rcq_ref.rcq_encode(data, lanes=k, inc=inc, climit_log2=cl)
    k = pick_lanes(n)
    inc, lim = adaptive_params_for(k)
    return rc_ref.adaptive_encode(data, lanes=k, inc=inc, limit_log2=lim)


def start_parallel_oracles(pool):
    """kennedy.xls's oracle containers at the sharded paths' parameters,
    computed by the oracle workers from the start: {codec: future}."""
    return {c: pool.submit(parallel_oracle, c) for c in ("rcx", "rcq", "rc2")}


def check_sharded_run(what: str, lane: int, launches: list, cases: list,
                      kernels=tuple(dryrun.FORMS.values())):
    """The sharded calls of a run went through the kernels' forms: with
    lane = 1 the one-shot kernels and no form, with lane = 2 every form in
    every process (`launches`: each process's counts) and no one-shot
    kernel, of `kernels` (A, C, D, E and J by default); each decode
    (`cases`, the run's case dicts) exchanges steps - 1 times with lane =
    2 and never with lane = 1, and no encode exchanges."""
    pairs = [(f, k) for f, k in dryrun.FORMS.items() if k in kernels]
    for i, c in enumerate(launches):
        forms = [f for f, _ in pairs if c[f]]
        one_shot = [k for _, k in pairs if c[k]]
        if lane == 1 and (forms or len(one_shot) < len(pairs)):
            fail(f"{what}, process {i}: lane 1 must run the one-shot kernels "
                 f"alone, launched {c}")
        if lane > 1 and (one_shot or len(forms) < len(pairs)):
            fail(f"{what}, process {i}: lane {lane} must run every form and "
                 f"no one-shot kernel, launched {c}")
    for v in cases:
        if v.get("enc_exchanges", 0):
            fail(f"{what}: an encode exchanged {v['enc_exchanges']} times")
        if "exchanges" in v and v["exchanges"] != (
                v["steps"] - 1 if lane > 1 else 0):
            fail(f"{what}: {v['exchanges']} exchanges over {v['steps']} "
                 f"steps at lane {lane}")


def phase_parallel(dev, smi_line: str, oracle_futures: dict):
    """The sharded paths (parallel/), each run alone on the card and the
    host, so that no reading is taken beside other work: the launch module
    under torchrun in one process at its default 2^24 bytes; the kernels'
    new forms against their plain versions (parallel_forms);
    dryrun_multichip over worlds of 1 (NCCL), 2 (mesh 1 x 2) and 4 (2 x
    2), on NCCL across cards where the card count reaches the world, else
    gloo with the ranks sharing cuda:0; in the world of 2 also kennedy.xls
    through the sharded CT-RCX at its rcx_params (wlog 0) and CT-RCQ at
    its rcq_params over lane = 2, each container against its oracle
    (`oracle_futures`, start_parallel_oracles') and the single-device one,
    the mesh decodes against the input, and CT-RC2's sharded encode there;
    then the launch module in two processes at 2^20. Every run is held to
    check_sharded_run. -> ({kernel: largest difference of its forms},
    {kernel: its forms' numbers}, {kernel: launches in the sharded calls,
    its forms' included}, notes)."""
    counts = dict.fromkeys(dryrun.COUNTERS, 0)
    cards = torch.cuda.device_count()

    def backend_for(world):
        return "nccl" if cards >= world else "gloo"

    def lane_of(world):
        return 2 if world % 2 == 0 and world > 1 else 1

    notes = []

    def torchrun(nproc, nbytes):
        row = timed(f"parallel torchrun x{nproc}", torchrun_wait,
                    torchrun_start(nproc, nbytes, backend_for(nproc)))
        for nm in counts:
            counts[nm] += row["launches"][nm]
        # the launch codes CT-RCX alone (its launches summed over the ranks)
        check_sharded_run(f"torchrun x{nproc}", lane_of(nproc),
                          [row["launches"]], [row],
                          ("rcx_encode", "rcx_decode"))
        print(f"[parallel] torchrun --nproc-per-node {nproc}: "
              f"{json.dumps(row)}; {smi_line}", flush=True)
        notes.append(f"torchrun x{nproc} roundtrip_ok")

    torchrun(*TORCHRUN[0])
    err, forms = timed("parallel forms", parallel_forms, dev)
    kennedy = corpus("kennedy.xls")
    n = len(kennedy)
    kx, inc_x, cl_x, cb_x = rcx_params(n)
    kq, inc_q, cl_q = rcq_params(n)
    k2 = pick_lanes(n)
    inc2, lim2 = adaptive_params_for(k2)
    for world in (1, 2, 4):
        tasks = [("dryrun", {})]
        if world == 2:
            oracles = {c: f.result() for c, f in oracle_futures.items()}
            tasks += [
                ("rcx", dict(data=kennedy, lane=2, blocks=1, k=kx, inc=inc_x,
                             climit_log2=cl_x, cbits=cb_x, wide_check=False,
                             oracles=[oracles["rcx"]])),
                ("rcq", dict(data=kennedy, lane=2, k=kq, inc=inc_q,
                             climit_log2=cl_q, oracles=[oracles["rcq"]])),
                ("rc2", dict(data=kennedy, lane=2, blocks=1, k=k2, inc=inc2,
                             limit_log2=lim2, oracles=[oracles["rc2"]]))]
        res = timed(f"parallel world {world}", lambda: spawn.run(
            world, dryrun.rank_main, tasks, backend=backend_for(world),
            device="cuda"))
        for r in res:
            if r.foreign:
                fail(f"a rank loaded {r.foreign}")
            for nm, c in r.launches.items():
                counts[nm] += c
        cases = [c for r in res for v in r.value
                 for c in ([v["rcx"], v["rcq"], v["rc2"]] if "rcx" in v
                           else [v])]
        check_sharded_run(f"dryrun_multichip({world})", lane_of(world),
                          [r.launches for r in res], cases)
        v, *extra = res[0].value
        print(f"[parallel] dryrun_multichip({world}) backend {v['backend']} "
              f"mesh {v['mesh']}: rcx enc {v['rcx']['enc_s']:.4f} s dec "
              f"{v['rcx']['dec_s']:.4f} s ({v['rcx']['exchanges']} "
              f"exchanges), rcq enc {v['rcq']['enc_s']:.4f} s dec "
              f"{v['rcq']['dec_s']:.4f} s ({v['rcq']['exchanges']} "
              f"exchanges), exchange {v['exchange_us']} us; launches in the "
              f"ranks' sharded calls {[r.launches for r in res]}; "
              f"{smi_line}", flush=True)
        notes.append(f"dryrun {world} ({v['backend']})")
        for (nm, _), v in zip(tasks[1:], extra):
            print(f"[parallel] kennedy.xls sharded {nm} K={v['lanes']} "
                  f"world 2 backend {v['backend']} mesh {v['mesh']}: "
                  f"container {v['compressed']} payload bytes == oracle's "
                  f"and the single-device container; enc {v['enc_s']:.4f} s"
                  + (f", mesh decode == input in {v['dec_s']:.4f} s over "
                     f"{v['steps']} steps ({v['exchanges']} exchanges, "
                     f"{v['dec_s'] / v['steps'] * 1e6:.1f} us a step), "
                     f"exchange {v['exchange_us']:.1f} us"
                     if nm != "rc2" else "") + f"; {smi_line}", flush=True)
    torchrun(*TORCHRUN[1])
    launches = {nm: counts[nm] + sum(counts[f] for f, k in dryrun.FORMS.items()
                                     if k == nm)
                for nm in PARALLEL_KERNELS}
    for f, k in dryrun.FORMS.items():
        forms[k]["parallel_launches"] = counts[f]
    idle = [nm for nm, c in counts.items() if c == 0]
    if idle:
        fail(f"kernels or forms never launched on the parallel path: {idle}")
    notes.append("kennedy.xls rcx/rcq/rc2 sharded == oracle")
    return err, forms, launches, notes


def bound(moved: int, ops: int):
    """-> (bound_ms, bound_by): the larger of bytes moved over the memory
    rate and operations over the peak rate."""
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                          "operations")


def timed(label: str, fn, *args):
    """fn(*args), then a line with the phase's seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[time] {label} {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main():
    t_start = time.perf_counter()
    name, smi_line = timed("env", phase_env)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    timed("build", phase_build)
    # the oracle containers of the stream path, made by worker processes
    # while the card works (spawned: they use no CUDA)
    pool = ProcessPoolExecutor(3, mp_context=multiprocessing.get_context(
        "spawn"))
    try:
        oracles = start_oracles(pool)
        p_oracles = start_parallel_oracles(pool)
        err, ms, work, ms_at, b_passes = timed("kernels A, B, C",
                                               phase_kernels, dev)
        rcq, rans, (*huffman, h_wrapper), exact, mtf, chunk, lz, stuv, wxy = (
            timed("kernels D, E", phase_kernels_rcq, dev),
            timed("kernels F, G", phase_kernels_rans, dev),
            timed("kernels H, I", phase_kernels_huffman, dev),
            timed("kernels J, L", phase_kernels_exact, dev),
            timed("kernels M, N", phase_kernels_mtf, dev),
            timed("kernel O", phase_kernels_chunk, dev),
            timed("kernels P, Q, R, Z, K", phase_kernels_lz, dev),
            timed("kernels S, T, U, V", phase_kernels_ase_o1, dev),
            timed("kernels W, X, Y", phase_kernels_ans2, dev))
        for e, m, w, a in (rcq, rans, huffman, exact, mtf, chunk, lz, stuv,
                           wxy):
            err.update(e)
            ms.update(m)
            work.update(w)
            ms_at.update(a)
        # a kernel on several paths (B) reports the sum of its paths' counts
        # and times, and each path's count apart
        launches = dict.fromkeys(COUNTERS, 0)
        main_ms = dict.fromkeys(COUNTERS, 0.0)
        by_path = {nm: {} for nm in COUNTERS}
        for codec in PATH_KERNELS:
            counts, times = timed(f"main {codec}", phase_main, codec, oracles)
            for nm, c in counts.items():
                launches[nm] += c
                main_ms[nm] += times[nm]
                by_path[nm][codec] = c
        for f in p_oracles.values():
            f.result()
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    print(f"[tooling] ok {timed('tooling', phase_tooling, smi_line)}",
          flush=True)
    p_err, forms, p_launches, p_notes = timed("parallel", phase_parallel,
                                              dev, smi_line, p_oracles)
    for nm, c in p_launches.items():
        launches[nm] += c
        by_path[nm]["parallel"] = c
        err[nm] = max(err[nm], p_err[nm])
    print(f"[parallel] ok {'; '.join(p_notes)}; launches {p_launches}",
          flush=True)
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "cpprcoder_tpu"))
    if loaded:
        fail(f"modules of jax or of the JAX package were imported: {loaded}")
    rows = []
    for nm, src, rep in KERNELS + SCAN_KERNELS:
        bound_ms, bound_by = bound(*work[nm])
        rows.append({"name": nm, "route": "cuda", "source": src,
                     "replaces": rep,
                     "tpu_kernel": rep if (nm, src, rep) in KERNELS else None,
                     "launches": launches[nm],
                     "launches_by_path": by_path[nm],
                     "main_ms": main_ms[nm],
                     "max_abs_err": err[nm], "ms": ms[nm][0],
                     "plain_ms": ms[nm][1], "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None})
        if nm in ms_at:     # kernel ms at each shape timed
            rows[-1]["ms_at"] = ms_at[nm]
        if nm == "expand":  # B's passes and host round trip apart
            rows[-1]["passes_ms"] = b_passes
        if nm == "huffman_encode":  # H through its wrapper
            rows[-1]["wrapper_ms"] = h_wrapper
        if nm in forms:     # its lane-range or stepped form
            rows[-1]["forms"] = forms[nm]
        if nm in ("lz_match_v1", "lz_match_v2"):  # both plain versions
            rows[-1]["tables_ms_at"] = TABLES_MS_AT
    print(f"[time] all {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
