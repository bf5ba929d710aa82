"""Kernel A and C wrappers: CT-RCX encode and decode on the card.

Kernel A (`csrc/rcx_encode.cu`) replaces cpprcoder_tpu/ops/rcx_pallas.py:163
`_encode_kernel`; kernel C (`csrc/rcx_decode.cu`) replaces
rcx_pallas.py:374 `_decode_kernel`. Both run one CTA per stream with the
context model in shared memory (global scratch for cbits = 8, whose 384 KB
model exceeds a block's 227 KB), lane state in registers, shared-memory
atomics for the model update and direct table indexing. A stream's steps
are sequential, so one stream is latency-bound on one SM.

Their plain versions are the step loops `rcx_ops.encode_events_plain` and
`rcx_ops.decode_symbols_plain`. On a CPU tensor a wrapper runs the plain
version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from cpprcoder_tpu_torch.native import build
from cpprcoder_tpu_torch.ops import rcx_ops

encode_launches = 0   # kernel A
decode_launches = 0   # kernel C

MAX_THREADS = 1024
MAX_LANES = 8 * MAX_THREADS      # csrc/rcx_model.cuh MAX_LPT * MAX_THREADS
SMEM_LIMIT = 232448              # dynamic shared memory a Hopper block may use


def model_bytes(cbits: int) -> int:
    """Bytes of one stream's model: C u32 [B,256] + cum u16 [B,257]
    (16-byte padded), as csrc/rcx_model.cuh lays it out."""
    rows = 1 << cbits
    return rows * 256 * 4 + ((rows * 257 * 2 + 15) & ~15)


def _check_common(name, t, dtype, lane_len, cbits, wlog, climit, inc):
    if t.dtype != dtype or t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D {dtype} tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")
    k = t.shape[1]
    if lane_len.dtype != torch.int32 or tuple(lane_len.shape) != (k,) \
            or not lane_len.is_contiguous():
        raise ValueError(f"lane_len must be int32 [{k}], got "
                         f"{lane_len.dtype} {tuple(lane_len.shape)}")
    if lane_len.device != t.device:
        raise ValueError("lane_len and the data must be on one device")
    if not (0 <= cbits <= 8 and 0 <= wlog <= 3):
        raise ValueError(f"cbits {cbits} / wlog {wlog} out of range")
    if t.device.type == "cuda":
        if k > MAX_LANES:
            raise ValueError(f"the CUDA kernels take K <= {MAX_LANES} "
                             f"lanes, got {k}")
        if not (0 < climit < 1 << 31 and 0 <= inc < 1 << 31):
            raise ValueError(f"climit {climit} / inc {inc} out of range")
    elif t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")


def _model_scratch(cbits: int, device) -> torch.Tensor | None:
    if model_bytes(cbits) <= SMEM_LIMIT:
        return None
    return torch.empty(model_bytes(cbits), dtype=torch.uint8, device=device)


def encode_events(x2d: torch.Tensor, lane_len: torch.Tensor, inc: int,
                  climit: int, cbits: int, wlog: int) -> torch.Tensor:
    """x2d [stride, K] uint8 (time-major chunked lanes) -> events
    [2*stride+2, K] int32 (u32 bits): 2 slots per step, then 2 flush rows."""
    global encode_launches
    _check_common("x2d", x2d, torch.uint8, lane_len, cbits, wlog, climit, inc)
    if x2d.device.type == "cpu":
        return rcx_ops.encode_events_plain(x2d, lane_len, inc, climit,
                                           cbits, wlog)
    stride, k = x2d.shape
    dev = x2d.device
    lib = build.load()
    with torch.cuda.device(dev):
        ev = torch.empty((2 * stride + 2, k), dtype=torch.int32, device=dev)
        scratch = _model_scratch(cbits, dev)
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
    _check_common("words", words, torch.int32, lane_len, cbits, wlog,
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
        scratch = _model_scratch(cbits, dev)
        rc = lib.ct_rcx_decode(
            words.data_ptr(), lane_len.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, 1, k, l4,
            stride, inc, climit, cbits, wlog,
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "ct_rcx_decode")
    decode_launches += 1
    return out[:n]
