"""Kernel J and L wrappers: CT-RC1 / CT-RC2 encode and decode on the card.

The JAX package has no Pallas kernel here: it runs each coder as one
compiled `lax.scan` on the device (cpprcoder_tpu/ops/range_ops.py:51-91
CT-RC1 encode, :94-132 CT-RC2 encode, :273-311 and :314-366 the decodes).
A PyTorch step loop on the card would launch about ten kernels a step, so
each scan is a kernel (`csrc/rc_exact.cu`): kernel J encodes, kernel L
decodes, one launch a call, every power of two up to 65,536 lanes.

J: CT-RC1's lanes share only a constant table, so they spread over CTAs
of 64 lanes. CT-RC2's model depends only on the input, so each CTA (64 lanes
up to K = 1,024, else 256) has producer warps that run ahead of its lanes: histogram warps
count the rows of x (staged in shared memory by cp.async), and a table
warp turns each row's histogram into the next table (counts, cum, total
and its magic number) in a ring in shared memory; the lanes wait only for
their step's table, never for each other. Every lane loads its symbols a
group of 8 steps early, divides range by the total with a multiply-high
and one correction, and writes time-major events [n_slots*stride + 2, K]
that kernel B expands.

L: CT-RC1's lanes spread over CTAs of 128, each CTA with a 2^16-entry
symbol table in shared memory (64 KiB, behind the opt-in); each lane
keeps its next words in registers. CT-RC2's step j+1 needs every lane's
step-j symbol: one barrier a step, after which every warp builds its own
copy of the table from the step's histogram; a lane finds its symbol as
the largest s with t*cum[s] <= code (no divide). Up to 4,096 lanes a CTA;
more run a cluster of up to 8 CTAs that read each other's histograms
through distributed shared memory.

n_slots comes from `range_ops.slots` (K, inc and limit_log2; the bound on
CT-RC2's total is proved there). Their plain versions are
`range_ops.encode_events_plain` and `range_ops.decode_symbols_plain`. On a
CPU tensor a wrapper runs the plain version; on a CUDA tensor it launches
the kernel or raises. Neither wrapper reads anything back from the card
before its launch.
"""

from __future__ import annotations

import torch

from cpprcoder_tpu_torch.native import build
from cpprcoder_tpu_torch.ops import layout, range_ops

encode_launches = 0   # kernel J
decode_launches = 0   # kernel L

MAX_LANES = 1 << 16   # CT-RC2 decode: a cluster of 8 CTAs of 8,192 lanes at most


def _check(name, t, dtype, lane_len, freqs, inc, limit_log2):
    layout.check_lanes(name, t, dtype, lane_len, MAX_LANES)
    k = t.shape[1]
    if t.device.type == "cuda" and k & (k - 1):
        raise ValueError(f"kernels J and L take a power of two up to "
                         f"{MAX_LANES} lanes, got {k}")
    if t.device.type == "cuda" and dtype == torch.uint8 and t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary on the "
                         f"card (kernel J reads rows in 16-byte loads)")
    if freqs is not None:
        if freqs.dtype != torch.int32 or tuple(freqs.shape) != (256,) \
                or freqs.device != t.device or not freqs.is_contiguous():
            raise ValueError("freqs must be int32 [256] beside the data")
    elif not (0 <= inc < 256 and 0 <= limit_log2 <= 31):
        raise ValueError(f"inc {inc} / limit_log2 {limit_log2} out of range")


def encode_events(x2d: torch.Tensor, lane_len: torch.Tensor,
                  freqs: torch.Tensor | None, inc: int,
                  limit_log2: int) -> torch.Tensor:
    """x2d [stride, K] uint8 (interleaved lanes: x2d[j, i] = x[j*K + i])
    -> events [n_slots*stride + 2, K] int32 (u32 bits). freqs: CT-RC1's
    static table, int32 [256] summing to 2^16; None for CT-RC2 (inc,
    limit_log2)."""
    global encode_launches
    _check("x2d", x2d, torch.uint8, lane_len, freqs, inc, limit_log2)
    if x2d.device.type == "cpu":
        return range_ops.encode_events_plain(x2d, lane_len, freqs, inc,
                                             limit_log2)
    stride, k = x2d.shape
    slots = range_ops.slots(freqs, limit_log2, k, inc)
    dev = x2d.device
    lib = build.load()
    with torch.cuda.device(dev):
        ev = torch.empty((slots * stride + 2, k), dtype=torch.int32,
                         device=dev)
        rc = lib.ct_rc_exact_encode(
            x2d.data_ptr(), lane_len.data_ptr(),
            None if freqs is None else freqs.data_ptr(), ev.data_ptr(), k,
            stride, inc, limit_log2, slots,
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "ct_rc_exact_encode")
    encode_launches += 1
    return ev


def decode_symbols(words: torch.Tensor, lane_len: torch.Tensor, n: int,
                   stride: int, freqs: torch.Tensor | None, inc: int,
                   limit_log2: int) -> torch.Tensor:
    """words [l4, K] int32 big-endian u32 word rows (word-major, l4 >= 1)
    -> the n decoded bytes, uint8 [n] (byte j*K + i is lane i's step j).
    freqs, inc and limit_log2 as for encode_events."""
    global decode_launches
    _check("words", words, torch.int32, lane_len, freqs, inc, limit_log2)
    l4, k = words.shape
    if l4 < 1 or not 0 <= n <= k * stride:
        raise ValueError(f"n={n} does not fit {k} lanes of stride {stride}, "
                         f"or no word rows ({l4})")
    if words.device.type == "cpu":
        return range_ops.decode_symbols_plain(words, lane_len, n, stride,
                                              freqs, inc, limit_log2)
    slots = range_ops.slots(freqs, limit_log2, k, inc)
    dev = words.device
    lib = build.load()
    with torch.cuda.device(dev):
        out = torch.empty(k * stride, dtype=torch.uint8, device=dev)
        rc = lib.ct_rc_exact_decode(
            words.data_ptr(), lane_len.data_ptr(),
            None if freqs is None else freqs.data_ptr(), out.data_ptr(), k,
            l4, stride, inc, limit_log2, slots,
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "ct_rc_exact_decode")
    decode_launches += 1
    return out[:n]
