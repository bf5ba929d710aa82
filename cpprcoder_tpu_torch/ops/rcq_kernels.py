"""Kernel D and E wrappers: CT-RCQ encode and decode on the card.

Kernel D (`csrc/rcq_encode.cu`) replaces cpprcoder_tpu/ops/rcq_pallas.py:324
`_encode_kernel`; kernel E (`csrc/rcq_decode.cu`) replaces rcq_pallas.py:151
`_decode_kernel`. They are kernels A and C (`csrc/rc_encode.cuh`,
`csrc/rc_decode.cuh`) instantiated for CT-RCQ: one model row C[256] shared
by the K interleaved lanes (1.5 KB of shared memory, so no scratch), a
requant before every step with a single halving, and E writing lane i's
step-j byte to j*K + i. Both requantize their one row between two
barriers with 8 warps, one cell a thread (`ct::requant_cells` in
`csrc/rcx_model.cuh`); E keeps the cum row in its search's tree order, D
sorted. D loads each lane's next symbol a step ahead, E its next word a
refill ahead.

Kernel O (`ct_rcq_encode_chunk`, in `csrc/rcq_encode.cu` beside D) is D
run from a given coder state and model, returning both, with the flush
only when asked: the steps of cpprcoder_tpu/codecs/resume.py:44
`_chunk_fn` (a lax.scan, no Pallas kernel) and its `_flush_fn`, for the
resumable encoder (codecs/resume.py). Its plain version is
`rcq_ops.encode_chunk_plain`.

For a stream whose lanes are sharded over a 'lane' group
(parallel/sharded_rcq.py), D's lane-range form (`encode_events_range`,
`ct_rcq_encode_range`) codes one rank's lanes against the model of every
lane, and E's stepped lane-range form (`decode_steps`,
`ct_rcq_decode_steps`) decodes one step of them from a state kept between
launches: kernel A's and C's forms with one row (rcx_kernels). Each form
counts its own launches (`range_launches`, `steps_launches`).

D's and E's plain versions are kernel A's and C's step loops
(`rcx_ops.encode_events_plain` / `decode_symbols_plain`) with cbits=0,
wlog=0, rounds=1 and the interleaved output. On a CPU tensor a wrapper
runs the plain version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from cpprcoder_tpu_torch.native import build
from cpprcoder_tpu_torch.ops import layout, rcq_ops, rcx_ops
from cpprcoder_tpu_torch.ops.rcq_ops import ROUNDS
from cpprcoder_tpu_torch.ops.rcx_kernels import (
    check_args,
    check_steps,
    launch_steps,
)

encode_launches = 0   # kernel D
decode_launches = 0   # kernel E
chunk_launches = 0    # kernel O
range_launches = 0    # kernel D's lane-range form
steps_launches = 0    # kernel E's stepped lane-range form


def encode_events(x2d: torch.Tensor, lane_len: torch.Tensor, inc: int,
                  climit: int) -> torch.Tensor:
    """x2d [stride, K] uint8 (interleaved lanes: x2d[j, i] = x[j*K + i])
    -> events [2*stride+2, K] int32 (u32 bits): 2 slots per step, then 2
    flush rows."""
    global encode_launches
    check_args("x2d", x2d, torch.uint8, lane_len, 0, 0, climit, inc)
    if x2d.device.type == "cpu":
        return rcx_ops.encode_events_plain(x2d, lane_len, inc, climit, 0, 0,
                                           ROUNDS)
    stride, k = x2d.shape
    dev = x2d.device
    lib = build.load()
    with torch.cuda.device(dev):
        ev = torch.empty((2 * stride + 2, k), dtype=torch.int32, device=dev)
        rc = lib.ct_rcq_encode(
            x2d.data_ptr(), lane_len.data_ptr(), ev.data_ptr(), k, stride,
            inc, climit, torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "ct_rcq_encode")
    encode_launches += 1
    return ev


def decode_symbols(words: torch.Tensor, lane_len: torch.Tensor, n: int,
                   stride: int, inc: int, climit: int) -> torch.Tensor:
    """words [l4, K] int32 big-endian u32 word rows (word-major) -> the
    n decoded bytes, uint8 [n] (byte j*K + i is lane i's step j)."""
    global decode_launches
    check_args("words", words, torch.int32, lane_len, 0, 0, climit, inc)
    l4, k = words.shape
    if not 0 <= n <= k * stride:
        raise ValueError(f"n={n} does not fit {k} lanes of stride {stride}")
    if words.device.type == "cpu":
        return rcx_ops.decode_symbols_plain(words, lane_len, n, stride, inc,
                                            climit, 0, 0, ROUNDS,
                                            interleaved=True)
    dev = words.device
    lib = build.load()
    with torch.cuda.device(dev):
        out = torch.empty(k * stride, dtype=torch.uint8, device=dev)
        rc = lib.ct_rcq_decode(
            words.data_ptr(), lane_len.data_ptr(), out.data_ptr(), k, l4,
            stride, inc, climit, torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "ct_rcq_decode")
    decode_launches += 1
    return out[:n]


def encode_chunk(x2d: torch.Tensor, lane_len: torch.Tensor, t0: int,
                 state: torch.Tensor, C: torch.Tensor, inc: int, climit: int,
                 flush: bool = False):
    """Kernel O: steps t0 .. t0 + steps - 1 of a CT-RCQ stream from a saved
    state. x2d [steps, K] uint8 (the chunk's interleaved rows; steps may be
    0); lane_len [K] int32, the steps each lane codes in the whole stream;
    state [5, K] int32 (u32 low, carry, range, cache, cache_size); C [256]
    int32. -> (events [2*steps + 2*flush, K] int32, state [5, K], C [256]),
    new tensors (rcq_ops.encode_chunk_plain has the contract)."""
    global chunk_launches
    check_args("x2d", x2d, torch.uint8, lane_len, 0, 0, climit, inc)
    steps, k = x2d.shape
    dev = x2d.device
    for name, t, shape in (("state", state, (5, k)), ("C", C, (256,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be a contiguous int32 {shape} "
                             f"tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if not 0 <= t0 < 1 << 31:
        raise ValueError(f"t0 {t0} out of range")
    if dev.type == "cpu":
        return rcq_ops.encode_chunk_plain(x2d, lane_len, t0, state, C, inc,
                                          climit, flush)
    lib = build.load()
    with torch.cuda.device(dev):
        ev = torch.empty((2 * steps + 2 * bool(flush), k), dtype=torch.int32,
                         device=dev)
        st_out = torch.empty_like(state)
        c_out = torch.empty_like(C)
        rc = lib.ct_rcq_encode_chunk(
            x2d.data_ptr(), lane_len.data_ptr(), ev.data_ptr(),
            state.data_ptr(), st_out.data_ptr(), C.data_ptr(),
            c_out.data_ptr(), k, steps, t0, int(bool(flush)), inc, climit,
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "ct_rcq_encode_chunk")
    chunk_launches += 1
    return ev, st_out, c_out


def encode_events_range(x2d: torch.Tensor, lane_len: torch.Tensor, l0: int,
                        ko: int, inc: int, climit: int) -> torch.Tensor:
    """Kernel D's lane-range form: encode_events(...)[:, l0:l0 + ko], the
    events [2*stride+2, ko] int32 of lanes l0 .. l0 + ko - 1, from the
    whole stream (every lane updates the model)."""
    global range_launches
    check_args("x2d", x2d, torch.uint8, lane_len, 0, 0, climit, inc)
    stride, k = x2d.shape
    layout.check_range(k, l0, ko)
    if x2d.device.type == "cpu":
        return rcx_ops.encode_events_plain(
            x2d, lane_len, inc, climit, 0, 0, ROUNDS)[:, l0:l0 + ko].contiguous()
    dev = x2d.device
    lib = build.load()
    with torch.cuda.device(dev):
        ev = torch.empty((2 * stride + 2, ko), dtype=torch.int32, device=dev)
        rc = lib.ct_rcq_encode_range(
            x2d.data_ptr(), lane_len.data_ptr(), ev.data_ptr(), k, stride,
            inc, climit, l0, ko, torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "ct_rcq_encode_range")
    range_launches += 1
    return ev


def decode_steps(words: torch.Tensor, lane_len: torch.Tensor, state,
                 xs: torch.Tensor, l0: int, t0: int, inc: int,
                 climit: int) -> torch.Tensor:
    """Kernel E's stepped lane-range form: step t0 of lanes l0 .. l0 + ko -
    1 (rcx_ops.decode_steps_plain with one row, one halving, a window a
    step; the state is rcx_ops.decode_state(words, K, 0), updated in
    place). -> out uint8 [S, 1, ko]."""
    global steps_launches
    check_steps(words, lane_len, state, xs, l0, t0, 1, 0, 0, inc, climit)
    if words.device.type == "cpu":
        return rcx_ops.decode_steps_plain(words, lane_len, state, xs, l0, t0,
                                          1, inc, climit, 0, ROUNDS)
    out = launch_steps("ct_rcq_decode_steps", words, lane_len, state, xs, l0,
                       t0, 1, inc, climit, ())
    steps_launches += 1
    return out
