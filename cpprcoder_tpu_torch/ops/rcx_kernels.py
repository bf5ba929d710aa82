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

For a stream whose lanes are sharded over the ranks of a 'lane' group
(parallel/sharded_rcx.py) each kernel has a second form. A's lane-range
form (`encode_events_range`, `ct_rcx_encode_range`) updates the model from
every lane, as A does, but codes and writes events only for one rank's
lanes; its plain version is A's plain version's columns of those lanes.
C's stepped lane-range form (`decode_steps`, `ct_rcx_decode_steps`)
decodes one window of one rank's lanes from a state kept between launches,
after the symbols of every lane's previous window (`rcx_ops.decode_state`,
`rcx_ops.decode_steps_plain`). Each form counts its own launches
(`range_launches`, `steps_launches`); a kernel's launches are those of its
forms together.
"""

from __future__ import annotations

import torch

from cpprcoder_tpu_torch.config import MASK32
from cpprcoder_tpu_torch.native import build
from cpprcoder_tpu_torch.ops import layout, rcx_ops

encode_launches = 0   # kernel A
decode_launches = 0   # kernel C
range_launches = 0    # kernel A's lane-range form
steps_launches = 0    # kernel C's stepped lane-range form

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


def encode_events_range(x2d: torch.Tensor, lane_len: torch.Tensor, l0: int,
                        ko: int, inc: int, climit: int, cbits: int,
                        wlog: int) -> torch.Tensor:
    """Kernel A's lane-range form: encode_events(...)[:, l0:l0 + ko], the
    events [2*stride+2, ko] int32 of lanes l0 .. l0 + ko - 1, from the
    whole stream x2d [stride, K] (every lane updates the model)."""
    global range_launches
    check_args("x2d", x2d, torch.uint8, lane_len, cbits, wlog, climit, inc)
    stride, k = x2d.shape
    layout.check_range(k, l0, ko)
    if x2d.device.type == "cpu":
        return rcx_ops.encode_events_plain(
            x2d, lane_len, inc, climit, cbits, wlog)[:, l0:l0 + ko].contiguous()
    dev = x2d.device
    lib = build.load()
    with torch.cuda.device(dev):
        ev = torch.empty((2 * stride + 2, ko), dtype=torch.int32, device=dev)
        scratch = _model_scratch(lib.ct_rcx_encode_scratch(k, cbits), dev)
        rc = lib.ct_rcx_encode_range(
            x2d.data_ptr(), lane_len.data_ptr(), ev.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, 1, k,
            stride, inc, climit, cbits, wlog, l0, ko,
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "ct_rcx_encode_range")
    range_launches += 1
    return ev


def check_steps(words, lane_len, state, xs, l0, t0, steps, cbits, wlog, inc,
                climit):
    """Raise ValueError on what the stepped decode does not take."""
    st, C, prev = state
    if not (0 < climit <= MASK32 and 0 <= inc < 1 << 31):
        raise ValueError(f"climit {climit} / inc {inc} out of range")
    if words.dtype != torch.int32 or words.dim() != 3 \
            or not words.is_contiguous() or words.shape[1] < 1:
        raise ValueError(f"words must be contiguous int32 [S, l4 >= 1, ko], "
                         f"got {words.dtype} {tuple(words.shape)}")
    n_s, _, ko = words.shape
    if lane_len.dim() != 2 or lane_len.shape[0] != n_s:
        raise ValueError(f"lane_len must be [{n_s}, K], got "
                         f"{tuple(lane_len.shape)}")
    k = lane_len.shape[1]
    layout.check_range(k, l0, ko)
    w = 1 << wlog
    if not (0 <= cbits <= 8 and 0 <= wlog <= 3 and t0 >= 0 and t0 % w == 0
            and 1 <= steps <= w and xs.shape[1] <= min(w, t0)):
        raise ValueError(f"window t0={t0} steps={steps} after {xs.shape[1]} "
                         f"steps is not a window of 2^{wlog} (cbits {cbits})")
    for name, t, dtype, shape in (
            ("lane_len", lane_len, torch.int32, (n_s, k)),
            ("st", st, torch.int32, (n_s, rcx_ops.STATE_ROWS, ko)),
            ("C", C, torch.int32, (n_s, 1 << cbits, 256)),
            ("prev", prev, torch.uint8, (n_s, k)),
            ("xs", xs, torch.uint8, (n_s, xs.shape[1], k))):
        if t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != words.device:
            raise ValueError(f"{name} must be a contiguous {dtype} {shape} "
                             f"tensor on {words.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def decode_steps(words: torch.Tensor, lane_len: torch.Tensor, state,
                 xs: torch.Tensor, l0: int, t0: int, steps: int, inc: int,
                 climit: int, cbits: int, wlog: int) -> torch.Tensor:
    """Kernel C's stepped lane-range form: one window of lanes l0 .. l0 +
    ko - 1 of S streams (rcx_ops.decode_steps_plain has the contract; the
    state is updated in place). -> out uint8 [S, steps, ko]."""
    global steps_launches
    check_steps(words, lane_len, state, xs, l0, t0, steps, cbits, wlog, inc,
                climit)
    if words.device.type == "cpu":
        return rcx_ops.decode_steps_plain(words, lane_len, state, xs, l0, t0,
                                          steps, inc, climit, cbits)
    out = launch_steps("ct_rcx_decode_steps", words, lane_len, state, xs,
                       l0, t0, steps, inc, climit, (cbits, wlog))
    steps_launches += 1
    return out


def launch_steps(entry: str, words, lane_len, state, xs, l0, t0, steps, inc,
                 climit, extra) -> torch.Tensor:
    """Launch a stepped decode entry point (C's or E's) on the card; the
    caller counts the launch."""
    st, C, prev = state
    n_s, l4, ko = words.shape
    dev = words.device
    lib = build.load()
    with torch.cuda.device(dev):
        out = torch.empty((n_s, steps, ko), dtype=torch.uint8, device=dev)
        rc = getattr(lib, entry)(
            words.data_ptr(), lane_len.data_ptr(), st.data_ptr(),
            C.data_ptr(), prev.data_ptr(), xs.data_ptr(), out.data_ptr(),
            n_s, lane_len.shape[1], l4, l0, ko, t0, steps, xs.shape[1], inc,
            climit, *extra, torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, entry)
    return out
