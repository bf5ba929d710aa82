"""Kernel F and G wrappers: CT-ANS1 v2 (interleaved rANS) on the card.

Kernel F (`csrc/rans_encode.cu`) replaces cpprcoder_tpu/ops/rans_pallas.py:76
`_encode_kernel`; kernel G (`csrc/rans_decode.cu`) replaces
rans_pallas.py:225 `_decode_kernel`. The table is static, so lanes are
independent: one thread per lane, tables in shared memory, any K up to
2^16. F divides by a multiply-high with a per-symbol reciprocal and one
exact correction, and loads each lane's bytes a run of steps ahead of its
state chain. G reads (f, slot - cum) from one table entry a slot, so a step
has one shared read on its chain, and keeps each lane's next words in
flight with cp.async.

Their plain versions are the step loops `rans_ops.encode_events_plain` and
`rans_ops.decode_symbols_plain`. On a CPU tensor a wrapper runs the plain
version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from cpprcoder_tpu_torch.native import build
from cpprcoder_tpu_torch.ops import layout, rans_ops

encode_launches = 0   # kernel F
decode_launches = 0   # kernel G

MAX_LANES = 1 << 16   # rans_ref._parse_lane_desc takes log2 K <= 16


def _check(name, t, dtype, lane_len, freqs, cums):
    layout.check_lanes(name, t, dtype, lane_len, MAX_LANES)
    for nm, v in (("freqs", freqs), ("cums", cums)):
        if v.dtype != torch.int32 or tuple(v.shape) != (256,) \
                or not v.is_contiguous():
            raise ValueError(f"{nm} must be int32 [256], got {v.dtype} "
                             f"{tuple(v.shape)}")
        if v.device != t.device:
            raise ValueError(f"{nm} and {name} must be on one device")


def encode_events(x2d: torch.Tensor, lane_len: torch.Tensor,
                  freqs: torch.Tensor, cums: torch.Tensor):
    """x2d [stride, K] uint8 (interleaved: x2d[j, i] = x[j*K + i]) ->
    (events [stride, K] int32: bit 16 emit, bits 15:0 the state's low word,
    0 where inactive; final states [K] int32 holding u32 bits)."""
    global encode_launches
    _check("x2d", x2d, torch.uint8, lane_len, freqs, cums)
    if x2d.device.type == "cpu":
        return rans_ops.encode_events_plain(x2d, lane_len, freqs, cums)
    stride, k = x2d.shape
    dev = x2d.device
    lib = build.load()
    with torch.cuda.device(dev):
        ev = torch.empty((stride, k), dtype=torch.int32, device=dev)
        states = torch.empty(k, dtype=torch.int32, device=dev)
        rc = lib.ct_rans_encode(
            x2d.data_ptr(), lane_len.data_ptr(), freqs.data_ptr(),
            cums.data_ptr(), ev.data_ptr(), states.data_ptr(), k, stride,
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "ct_rans_encode")
    encode_launches += 1
    return ev, states


def decode_symbols(states: torch.Tensor, rows: torch.Tensor,
                   lane_len: torch.Tensor, freqs: torch.Tensor,
                   cums: torch.Tensor, n: int, stride: int) -> torch.Tensor:
    """states [K] int32 (u32 bits), rows [l2, K] int32 (u16 words,
    word-major, zero past each lane's count) -> uint8 [n] (byte j*K + i is
    lane i's step j)."""
    global decode_launches
    _check("rows", rows, torch.int32, lane_len, freqs, cums)
    l2, k = rows.shape
    if states.dtype != torch.int32 or tuple(states.shape) != (k,) \
            or states.device != rows.device or not states.is_contiguous():
        raise ValueError(f"states must be int32 [{k}] on {rows.device}, got "
                         f"{states.dtype} {tuple(states.shape)}")
    if not 0 <= n <= k * stride:
        raise ValueError(f"n={n} does not fit {k} lanes of stride {stride}")
    if rows.device.type == "cpu":
        return rans_ops.decode_symbols_plain(states, rows, lane_len, freqs,
                                             cums, n, stride)
    dev = rows.device
    lib = build.load()
    with torch.cuda.device(dev):
        out = torch.empty(k * stride, dtype=torch.uint8, device=dev)
        rc = lib.ct_rans_decode(
            states.data_ptr(), rows.data_ptr(), lane_len.data_ptr(),
            freqs.data_ptr(), cums.data_ptr(), out.data_ptr(), k, l2, stride,
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "ct_rans_decode")
    decode_launches += 1
    return out[:n]
