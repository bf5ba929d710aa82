"""Kernel A and C wrappers: CT-RCX encode and decode on the card.

Kernel A (`csrc/rcx_encode.cu`) replaces cpprcoder_tpu/ops/rcx_pallas.py:163
`_encode_kernel`; kernel C (`csrc/rcx_decode.cu`) replaces
rcx_pallas.py:374 `_decode_kernel`. Both (`csrc/rc_encode.cuh`,
`csrc/rc_decode.cuh`) run one CTA per stream below 1024 lanes and a
cluster of 4 CTAs from there on, each holding a quarter of the lanes, the
counts of a quarter of the rows and a copy of every cum row (so the model
fits shared memory at any cbits; a lone CTA at cbits = 8 takes global
scratch), lane state in registers and shared-memory atomics for the model
update. They requantize only the rows that changed, with at least a warp
a row, and load each lane's next symbol (A) or word (C) ahead; a stream's
steps are sequential, so one stream is latency-bound. The library says how
much global model scratch a launch needs (`ct_rcx_*_scratch`).

Their plain versions are the step loops `rcx_ops.encode_events_plain` and
`rcx_ops.decode_symbols_plain`. On a CPU tensor a wrapper runs the plain
version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from cpprcoder_tpu_torch.config import MASK32
from cpprcoder_tpu_torch.native import build
from cpprcoder_tpu_torch.ops import layout, rcx_ops

encode_launches = 0   # kernel A
decode_launches = 0   # kernel C

# every power of two that K * inc <= 49,152 admits (models/qmodel.py): A and
# C as a 4-block cluster of 1024 threads with 8 lanes each, D and E as one
# block with 32
MAX_LANES = 1 << 15


def check_args(name, t, dtype, lane_len, cbits, wlog, climit, inc):
    """Raise ValueError on what the coder kernels (A, C, D, E) do not take:
    climit is the u32 of rc_common.climit_u32."""
    layout.check_lanes(name, t, dtype, lane_len, MAX_LANES)
    if not (0 <= cbits <= 8 and 0 <= wlog <= 3):
        raise ValueError(f"cbits {cbits} / wlog {wlog} out of range")
    if not (0 < climit <= MASK32 and 0 <= inc < 1 << 31):
        raise ValueError(f"climit {climit} / inc {inc} out of range")


def _model_scratch(nbytes: int, device) -> torch.Tensor | None:
    """The global model scratch the library asked for (None for 0 bytes)."""
    if nbytes == 0:
        return None
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


def encode_events(x2d: torch.Tensor, lane_len: torch.Tensor, inc: int,
                  climit: int, cbits: int, wlog: int) -> torch.Tensor:
    """x2d [stride, K] uint8 (time-major chunked lanes) -> events
    [2*stride+2, K] int32 (u32 bits): 2 slots per step, then 2 flush rows."""
    global encode_launches
    check_args("x2d", x2d, torch.uint8, lane_len, cbits, wlog, climit, inc)
    if x2d.device.type == "cpu":
        return rcx_ops.encode_events_plain(x2d, lane_len, inc, climit,
                                           cbits, wlog)
    stride, k = x2d.shape
    dev = x2d.device
    lib = build.load()
    with torch.cuda.device(dev):
        ev = torch.empty((2 * stride + 2, k), dtype=torch.int32, device=dev)
        scratch = _model_scratch(lib.ct_rcx_encode_scratch(k, cbits), dev)
        rc = lib.ct_rcx_encode(
            x2d.data_ptr(), lane_len.data_ptr(), ev.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, 1, k,
            stride, inc, climit, cbits, wlog,
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "ct_rcx_encode")
    encode_launches += 1
    return ev


def decode_symbols(words: torch.Tensor, lane_len: torch.Tensor, n: int,
                   stride: int, inc: int, climit: int, cbits: int,
                   wlog: int) -> torch.Tensor:
    """words [l4, K] int32 big-endian u32 word rows (word-major) -> the
    n decoded bytes, uint8 [n] (byte i*stride + j is lane i's step j)."""
    global decode_launches
    check_args("words", words, torch.int32, lane_len, cbits, wlog,
               climit, inc)
    l4, k = words.shape
    if not 0 <= n <= k * stride:
        raise ValueError(f"n={n} does not fit {k} lanes of stride {stride}")
    if words.device.type == "cpu":
        return rcx_ops.decode_symbols_plain(words, lane_len, n, stride, inc,
                                            climit, cbits, wlog)
    dev = words.device
    lib = build.load()
    with torch.cuda.device(dev):
        out = torch.empty(k * stride, dtype=torch.uint8, device=dev)
        scratch = _model_scratch(lib.ct_rcx_decode_scratch(k, cbits), dev)
        rc = lib.ct_rcx_decode(
            words.data_ptr(), lane_len.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, 1, k, l4,
            stride, inc, climit, cbits, wlog,
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "ct_rcx_decode")
    decode_launches += 1
    return out[:n]
