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
from cpprcoder_tpu_torch.ops import layout, rc_common
from cpprcoder_tpu_torch.reference.rc_ref import _lane_desc, _parse_lane_desc


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
