"""Oracle (host, exact) implementation of CT-RCQ, the quantized-model
adaptive range coder (the port's own copy of
cpprcoder_tpu/reference/rcq_ref.py). FORMAT (little-endian):

    [u32 rawSize n]
    [u8  lane_desc: log2(K) | 0x80 if wide sizes]
    [u8  inc] [u8 climit_log2] [u8 qbits (== models.qmodel.QBITS)]
    [K x u16 (or u32 if wide) per-lane payload sizes]
    [concatenated per-lane payloads, lane order]

Coding core = the shared CT range coder (reference/rc_ref.py); the decoder
preloads 4 bytes per lane (zero-filled past each lane's end). The model
total is a power of two (QBITS), so t = range >> qbits and there are at
most 2 renormalization byte shifts per symbol.

Layout is round-robin: lane i codes x[t*K + i] at step t; the model window
is one step (K symbols), updated identically on both sides.
"""

from __future__ import annotations

import numpy as np

from cpprcoder_tpu_torch.core.bytesutil import ByteReader, ByteWriter, as_u8
from cpprcoder_tpu_torch.models.qmodel import (
    QBITS,
    quantize_np,
    rcq_params,
    rescale_np,
    update_np,
)
from cpprcoder_tpu_torch.reference.rc_ref import (
    LaneDecoder,
    LaneEncoder,
    _lane_desc,
    _parse_lane_desc,
    _write_sizes,
)


def rcq_encode(data, lanes: int | None = None, inc: int | None = None,
               climit_log2: int | None = None) -> bytes:
    x = as_u8(data)
    n = len(x)
    k, inc0, cl0 = rcq_params(n, lanes)
    inc = inc if inc is not None else inc0
    climit_log2 = climit_log2 if climit_log2 is not None else cl0
    w = ByteWriter().u32(n)
    if n == 0:
        return (w.u8(_lane_desc(k, False)).u8(inc).u8(climit_log2)
                .u8(QBITS).getvalue())
    climit = 1 << climit_log2
    steps = -(-n // k)
    pad = np.zeros(steps * k, np.uint8)
    pad[:n] = x
    cols = pad.reshape(steps, k)
    encs = [LaneEncoder() for _ in range(k)]
    C = np.ones(256, np.uint32)
    for t_idx in range(steps):
        C = rescale_np(C, climit)
        q = quantize_np(C)
        cums = np.concatenate(([0], np.cumsum(q[:255]))).astype(np.uint32)
        n_active = min(k, n - t_idx * k)
        syms = cols[t_idx, :n_active]
        for i in range(n_active):
            e = encs[i]
            s = int(syms[i])
            e.encode(int(cums[s]), int(q[s]), 1 << QBITS, e.range >> QBITS)
        C = update_np(C, syms, inc)
    payloads = [e.finish() for e in encs]
    sizes = [len(p) for p in payloads]
    wide = max(sizes) >= 1 << 16
    w.u8(_lane_desc(k, wide)).u8(inc).u8(climit_log2).u8(QBITS)
    _write_sizes(w, sizes, wide)
    for p in payloads:
        w.raw(p)
    return w.getvalue()


def rcq_decode(blob) -> bytes:
    r = ByteReader(blob)
    n = r.u32()
    k, wide = _parse_lane_desc(r.u8())
    inc = r.u8()
    climit = 1 << r.u8()
    qbits = r.u8()
    assert qbits == QBITS, f"container qbits {qbits} != build {QBITS}"
    if n == 0:
        return b""
    sizes = (r.u32s(k) if wide else r.u16s(k)).astype(np.int64)
    payload = r.rest()
    offsets = np.concatenate(([0], np.cumsum(sizes)))
    decs = [LaneDecoder(payload[offsets[j]:offsets[j + 1]]) for j in range(k)]
    steps = -(-n // k)
    out = np.zeros(steps * k, np.uint8)
    C = np.ones(256, np.uint32)
    for t_idx in range(steps):
        C = rescale_np(C, climit)
        q = quantize_np(C)
        cums = np.concatenate(([0], np.cumsum(q[:255]))).astype(np.uint32)
        n_active = min(k, n - t_idx * k)
        for i in range(n_active):
            d = decs[i]
            t = d.range >> QBITS
            # find s = max{s : cums[s]*t <= code} (u32-exact products)
            s = int(np.searchsorted(cums * t, d.code, side="right")) - 1
            d.consume(int(cums[s]), int(q[s]), 1 << QBITS, t)
            out[t_idx * k + i] = s
        C = update_np(C, out[t_idx * k: t_idx * k + n_active], inc)
    return out[:n].tobytes()
