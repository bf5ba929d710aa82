"""Kernel J and L wrappers: CT-RC1 / CT-RC2 encode and decode on the card.

The JAX package has no Pallas kernel here: it runs each coder as one
compiled `lax.scan` on the device (cpprcoder_tpu/ops/range_ops.py:51-91
CT-RC1 encode, :94-132 CT-RC2 encode, :273-311 and :314-366 the decodes).
A PyTorch step loop on the card would launch about ten kernels a step, so
each scan is a kernel (`csrc/rc_exact.cu`): kernel J encodes, kernel L
decodes. One CTA codes one stream, its K interleaved lanes at up to 8 a
thread (K <= 8,192, the most `pick_lanes` gives); the model, freqs[256]
and its exclusive cum, sits in shared memory. For CT-RC2 one warp rescales
the table and scans it before each step between two barriers, the lanes
code against it (t = range / total, an integer divide) and add inc to
their symbol's count with shared-memory atomics; CT-RC1 takes the static
table once (t = range >> 16). J writes time-major events [n_slots*stride
+ 2, K] that kernel B expands; L feeds each lane from its word row through
a 64-bit byte queue and finds the symbol by a binary search over the cum
row. A stream's steps are sequential, so one stream is latency-bound.

Their plain versions are `range_ops.encode_events_plain` and
`range_ops.decode_symbols_plain`. On a CPU tensor a wrapper runs the plain
version; on a CUDA tensor it launches the kernel or raises. Neither wrapper
reads anything back from the card before its launch.
"""

from __future__ import annotations

import torch

from cpprcoder_tpu_torch.native import build
from cpprcoder_tpu_torch.ops import layout, range_ops

encode_launches = 0   # kernel J
decode_launches = 0   # kernel L

MAX_LANES = 8192      # 1024 threads, 8 lanes each


def _check(name, t, dtype, lane_len, freqs, inc, limit_log2):
    layout.check_lanes(name, t, dtype, lane_len, MAX_LANES)
    k = t.shape[1]
    if t.device.type == "cuda" and k & (k - 1):
        raise ValueError(f"kernels J and L take a power of two up to "
                         f"{MAX_LANES} lanes, got {k}")
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
    slots = range_ops.slots(freqs, limit_log2)
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
    slots = range_ops.slots(freqs, limit_log2)
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
