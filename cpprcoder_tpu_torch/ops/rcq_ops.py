"""CT-RCQ container path in PyTorch (counterpart of
cpprcoder_tpu/ops/rcq_ops.py, with the interleaved branch of
range_ops._encode_container).

Format: reference/rcq_ref.py. Lane i codes x[j*K + i] at step
j, for the stride = ceil(n/K) steps; one model C[256] is shared by all
lanes and requantized before every step (models/qmodel.py: one halving).
The port runs exactly `stride` steps: the JAX package's `bucket` padding
steps are inactive and change no state, so the bytes are the same.

`rcq_encode`/`rcq_decode` build containers around the kernel D/E wrappers
(ops/rcq_kernels.py), so the same code runs the kernels on a CUDA device
and their plain versions on the CPU; events become payload bytes through
kernel B (ops/expand.py), and the lane layout and the container pieces
are ops/layout.py's, as for CT-RCX.
"""

from __future__ import annotations

import torch

from cpprcoder_tpu_torch.core.bytesutil import (
    ByteReader,
    ByteWriter,
    CorruptContainerError,
    as_u8,
)
from cpprcoder_tpu_torch.models.cxmodel import QBITS, rcq_params
from cpprcoder_tpu_torch.ops import layout, rc_common, rcx_ops
from cpprcoder_tpu_torch.reference.rc_ref import _lane_desc, _parse_lane_desc


ROUNDS = 1   # CT-RCQ halves once (models/qmodel.py rescale)


def header(n, k, wide, inc, climit_log2) -> ByteWriter:
    """CT-RCQ header: u32 n, lane_desc, inc, climit_log2, QBITS."""
    return (ByteWriter().u32(n).u8(_lane_desc(k, wide)).u8(inc)
            .u8(climit_log2).u8(QBITS))


def rcq_encode(data, lanes: int | None = None, inc: int | None = None,
               climit_log2: int | None = None, *, device) -> bytes:
    """CT-RCQ container of `data`, coded on `device` (kernels on CUDA,
    plain versions on the CPU). Same parameters as rcq_ref.rcq_encode."""
    x = as_u8(data)
    n = len(x)
    k, inc0, cl0 = rcq_params(n, lanes)
    inc = inc0 if inc is None else inc
    climit_log2 = cl0 if climit_log2 is None else climit_log2
    if n == 0:
        return header(0, k, False, inc, climit_log2).getvalue()
    stride = -(-n // k)
    # a lane's pending run of 0xFF bytes must fit the event's 22-bit field
    if 3 * stride + 2 >= 1 << rc_common.EV_RUN_BITS:
        raise ValueError(f"{n} bytes over {k} lanes exceed one container "
                         f"(stride {stride}); split the input")
    from cpprcoder_tpu_torch.ops import expand, rcq_kernels

    xt = torch.from_numpy(x.copy()).to(device)
    events = rcq_kernels.encode_events(
        layout.pad2d_interleaved(xt, k, stride),
        layout.lane_lengths_interleaved(n, k, stride, xt.device),
        inc, rc_common.climit_u32(climit_log2, n, inc))
    rows, sizes = expand.materialize_rows(events)
    return layout.assemble(
        lambda wide: header(n, k, wide, inc, climit_log2),
        rows.cpu().numpy(), sizes.cpu().numpy())


def encode_chunk_plain(x2d: torch.Tensor, lane_len: torch.Tensor, t0: int,
                       state: torch.Tensor, C: torch.Tensor, inc: int,
                       climit: int, flush: bool):
    """Plain version of kernel O (ops/rcq_kernels.encode_chunk): steps t0 ..
    t0 + steps - 1 of CT-RCQ's encode from a saved coder state, as
    cpprcoder_tpu/codecs/resume.py `_chunk_fn` (and `_flush_fn` where
    `flush`) computes them.

    x2d [steps, K] uint8 (the chunk's interleaved rows); lane_len [K] int32,
    the steps each lane codes in the whole stream (lane i codes row j iff
    t0 + j < lane_len[i]); state [5, K] int32 (u32 bits of low, carry,
    range, cache, cache_size); C [256] int32, the counts after the last
    step before the chunk. -> (events [2*steps (+2 flush rows), K] int32,
    state [5, K] int32, C [256] int32): C after the chunk's last step's
    updates, not requantized, so that the next chunk's first step
    requantizes it as the one-shot encode would; the state after the steps
    (the flush ends the stream and leaves no state to resume from)."""
    steps = x2d.shape[0]
    lens = torch.clamp(lane_len.to(torch.int64) - t0, 0, steps)
    st = tuple(rc_common.i32_to_u32(state))
    st, C2, ev = rcx_ops.encode_steps_plain(
        x2d, lens, st, rc_common.i32_to_u32(C)[None, :], inc, climit, 0, 0,
        ROUNDS)
    if flush:
        ev = torch.cat([ev, rc_common.flush(st)])
    return (rc_common.u32_to_i32(ev), rc_common.u32_to_i32(torch.stack(st)),
            rc_common.u32_to_i32(C2[0]))


def parse_rcq_header(r: ByteReader):
    """-> (n, k, wide, inc, climit_log2); rejects a qbits other than
    QBITS."""
    n = r.u32()
    k, wide = _parse_lane_desc(r.u8())
    inc = r.u8()
    climit_log2 = r.u8()
    qbits = r.u8()
    if qbits != QBITS:
        raise CorruptContainerError(
            f"container qbits {qbits} != build {QBITS}")
    return n, k, wide, inc, climit_log2


def rcq_decode(blob, *, device) -> bytes:
    r = ByteReader(blob)
    n, k, wide, inc, climit_log2 = parse_rcq_header(r)
    if n == 0:
        return b""
    from cpprcoder_tpu_torch.ops import rcq_kernels

    stride = -(-n // k)
    words = layout.payload_words(r, k, wide, device)
    out = rcq_kernels.decode_symbols(
        words, layout.lane_lengths_interleaved(n, k, stride, words.device),
        n, stride, inc, rc_common.climit_u32(climit_log2, n, inc))
    return out.cpu().numpy().tobytes()
