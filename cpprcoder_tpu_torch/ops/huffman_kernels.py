"""Kernel H and I wrappers: CT-HUF1 (canonical Huffman) on the card.

Kernel H (`csrc/huffman_encode.cu`) replaces
cpprcoder_tpu/ops/huffman_pallas.py:79 `_encode_kernel`; kernel I
(`csrc/huffman_decode.cu`) replaces huffman_pallas.py:220
`_decode_kernel`. The code is static, so lanes are independent: one
thread per lane, the tables in shared memory, any K up to 2^16. Kernel I
keeps each lane's next words in flight (cp.async into shared memory) and
reads codes of up to 12 bits from a table of (length, symbol) entries.

Their plain versions are the step loops `huffman_ops.encode_events_plain`
and `huffman_ops.decode_symbols_plain`. On a CPU tensor a wrapper runs the
plain version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from cpprcoder_tpu_torch.native import build
from cpprcoder_tpu_torch.ops import huffman_ops, layout

encode_launches = 0   # kernel H
decode_launches = 0   # kernel I

MAX_LANES = 1 << 16   # the lane descriptor's largest log2 K that decodes


def _check_table(name: str, t: torch.Tensor, shape: tuple, like: torch.Tensor):
    if t.dtype != torch.int32 or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be int32 {list(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if t.device != like.device:
        raise ValueError(f"{name} must be on {like.device}, got {t.device}")


def encode_events(x2d: torch.Tensor, lane_len: torch.Tensor,
                  tab: torch.Tensor):
    """x2d [stride, K] uint8 (interleaved: x2d[j, i] = x[j*K + i]) and the
    code table tab [2, 256] int32 (lengths, LSB-first codes) -> (events
    [stride, K] int32: bit 16 emit, bits 15:0 the accumulator's low word,
    0 where inactive; flush [K] int32, the same layout; bit counts [K]
    int32)."""
    global encode_launches
    layout.check_lanes("x2d", x2d, torch.uint8, lane_len, MAX_LANES)
    _check_table("tab", tab, (2, 256), x2d)
    if x2d.device.type == "cpu":
        return huffman_ops.encode_events_plain(x2d, lane_len, tab)
    stride, k = x2d.shape
    dev = x2d.device
    lib = build.load()
    with torch.cuda.device(dev):
        ev = torch.empty((stride, k), dtype=torch.int32, device=dev)
        flush = torch.empty(k, dtype=torch.int32, device=dev)
        bits = torch.empty(k, dtype=torch.int32, device=dev)
        rc = lib.ct_huffman_encode(
            x2d.data_ptr(), lane_len.data_ptr(), tab.data_ptr(),
            ev.data_ptr(), flush.data_ptr(), bits.data_ptr(), k, stride,
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "ct_huffman_encode")
    encode_launches += 1
    return ev, flush, bits


def decode_symbols(rows: torch.Tensor, lane_len: torch.Tensor,
                   limits: torch.Tensor, bases: torch.Tensor,
                   perm: torch.Tensor, n: int, stride: int) -> torch.Tensor:
    """rows [l2, K] int32 (u16 words, word-major, zero past each lane's
    count) and the canonical tables limits [16], bases [16], perm [256]
    (int32 holding u32 bits) -> uint8 [n] (byte j*K + i is lane i's step
    j)."""
    global decode_launches
    layout.check_lanes("rows", rows, torch.int32, lane_len, MAX_LANES)
    for name, t, shape in (("limits", limits, (16,)), ("bases", bases, (16,)),
                           ("perm", perm, (256,))):
        _check_table(name, t, shape, rows)
    l2, k = rows.shape
    if not 0 <= n <= k * stride:
        raise ValueError(f"n={n} does not fit {k} lanes of stride {stride}")
    if rows.device.type == "cpu":
        return huffman_ops.decode_symbols_plain(rows, lane_len, limits, bases,
                                                perm, n, stride)
    dev = rows.device
    lib = build.load()
    with torch.cuda.device(dev):
        out = torch.empty(k * stride, dtype=torch.uint8, device=dev)
        rc = lib.ct_huffman_decode(
            rows.data_ptr(), lane_len.data_ptr(), limits.data_ptr(),
            bases.data_ptr(), perm.data_ptr(), out.data_ptr(), k, l2, stride,
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "ct_huffman_decode")
    decode_launches += 1
    return out[:n]
