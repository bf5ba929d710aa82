"""Kernel S and T wrappers: CT-ASE1 encode and decode on the card.

The JAX package has no Pallas kernel here: it runs each direction as one
compiled `lax.scan` (cpprcoder_tpu/ops/ase_ops.py:47 `_encode_fn`, scan
:89, whose words `rans_ops._stream_fn` places, :165-167; :103
`_decode_fn`, scan :148). Both kernels are in `csrc/ase.cu`: every lane
has its own 64-entry recency table, so lanes share nothing.

S (second round): the encoder's table is a function of the input alone,
so a lane's steps are cut into segments (`ase_ops.segment_steps`) that
code side by side, each from its start table: six launches, counted as
one, nothing read back. 1, a thread a segment: its distinct bytes, newest
first (64 at most), and their 256-bit set; 2, a warp a lane, over its
segments: the LRU composition of those, each segment's start table; 3, a
thread a segment: its bit count, coding from its start table (16
registers, a zero-byte test a word to find, funnel shifts to move); 4, up
to 32 threads a lane: its segment offsets and bit count; 5, one CTA: the
lanes' first words; 6, a thread a segment: the same coding again, writing
each word whose first
bit is its own (coding on into the next segment's steps to finish the
last), and the payload's tail zeroed. The scratch is
`ase_ops.segment_scratch_words` (at most 17.3 MB, whatever n).

T: the same table, spread over a quad of 4 threads a lane (16 entries
each; a hit's entry is one shuffle from its owner, the update 4 words a
thread and one shuffle down, the coder state copied in each thread), a
warp (8 lanes) a CTA; each lane reads a 32-bit window of its words,
taking a word whenever 16 bits or fewer are left, from registers loaded a
group of 4 words ahead, and writes out[j*K + i] (coalesced over the
lanes).

Their plain versions are `ase_ops.encode_words_plain` and
`ase_ops.decode_symbols_plain`. On a CPU tensor a wrapper runs the plain
version; on a CUDA tensor it launches the kernel or raises. Both take
every power of two up to 65,536 lanes.
"""

from __future__ import annotations

import torch

from cpprcoder_tpu_torch.native import build
from cpprcoder_tpu_torch.ops import ase_ops, layout

encode_launches = 0   # kernel S (its launches count as one)
decode_launches = 0   # kernel T

MAX_LANES = 1 << 16   # the lane descriptor's largest log2 K that decodes


def _check_lane_count(k: int):
    if not 1 <= k <= MAX_LANES or k & (k - 1):
        raise ValueError(f"kernels S and T take a power of two of "
                         f"1..{MAX_LANES} lanes, got {k}")


def encode_words(x2d: torch.Tensor, lane_len: torch.Tensor,
                 seg_steps: int | None = None):
    """x2d [stride, K] uint8 (interleaved: x2d[j, i] = x[j*K + i]; K a
    power of two) -> (payload int16 [K * ase_ops.words_cap(stride)]: the
    lanes' u16 words lane after lane, zero past them; bits [K] int32, each
    lane's bit count). seg_steps (the card only; the output does not
    depend on it) overrides ase_ops.segment_steps."""
    global encode_launches
    layout.check_lanes("x2d", x2d, torch.uint8, lane_len, MAX_LANES)
    stride, k = x2d.shape
    _check_lane_count(k)
    if x2d.device.type == "cpu":
        return ase_ops.encode_words_plain(x2d, lane_len)
    cap = ase_ops.words_cap(stride)
    if k * cap >= 1 << 31:
        raise ValueError(f"{k} lanes of {stride} steps exceed the kernel's "
                         f"31-bit word offsets")
    seg = seg_steps or ase_ops.segment_steps(k, stride)
    if not 1 <= seg or k * -(-stride // seg) >= ase_ops.MAX_SEGMENTS:
        raise ValueError(f"{seg} steps a segment over {k} lanes of {stride}")
    dev = x2d.device
    lib = build.load()
    with torch.cuda.device(dev):
        scratch = torch.empty(ase_ops.segment_scratch_words(k, stride, seg),
                              dtype=torch.int32, device=dev)
        payload = torch.empty(k * cap, dtype=torch.int16, device=dev)
        bits = torch.empty(k, dtype=torch.int32, device=dev)
        rc = lib.ct_ase_encode(
            x2d.data_ptr(), lane_len.data_ptr(), scratch.data_ptr(),
            bits.data_ptr(), payload.data_ptr(), k, stride, seg,
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "ct_ase_encode")
    encode_launches += 1
    return payload, bits


def decode_symbols(words: torch.Tensor, bases: torch.Tensor,
                   counts: torch.Tensor, lane_len: torch.Tensor, n: int,
                   stride: int) -> torch.Tensor:
    """words [P] int16 (the container's u16 words, lane after lane), bases
    and counts [K] int32 (each lane's first word and word count) -> uint8
    [n] (byte j*K + i is lane i's step j)."""
    global decode_launches
    k = lane_len.numel()
    for name, t in (("bases", bases), ("counts", counts),
                    ("lane_len", lane_len)):
        if t.dtype != torch.int32 or tuple(t.shape) != (k,) \
                or not t.is_contiguous() or t.device != words.device:
            raise ValueError(f"{name} must be int32 [{k}] beside the words, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if words.dtype != torch.int16 or words.dim() != 1 \
            or not words.is_contiguous():
        raise ValueError(f"words must be a contiguous 1-D int16 tensor, got "
                         f"{words.dtype} {tuple(words.shape)}")
    _check_lane_count(k)
    if not 0 <= n <= k * stride:
        raise ValueError(f"n={n} does not fit {k} lanes of stride {stride}")
    if words.device.type == "cpu":
        return ase_ops.decode_symbols_plain(words, bases, counts, lane_len, n,
                                            stride)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    dev = words.device
    lib = build.load()
    with torch.cuda.device(dev):
        out = torch.empty(n, dtype=torch.uint8, device=dev)
        rc = lib.ct_ase_decode(
            words.data_ptr(), words.numel(), bases.data_ptr(),
            counts.data_ptr(), lane_len.data_ptr(), out.data_ptr(), k,
            stride, torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "ct_ase_decode")
    decode_launches += 1
    return out
