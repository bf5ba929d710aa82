"""Oracle (host, exact) implementation of CT-RCX, the context-conditioned
quantized adaptive range coder (the port's own copy of
cpprcoder_tpu/reference/rcx_ref.py; model: models/cxmodel.py). FORMAT
(little-endian):

    [u32 rawSize n]
    [u8  lane_desc: log2(K) | 0x80 if wide sizes]
    [u8  inc] [u8 climit_log2] [u8 qbits (== models.qmodel.QBITS)]
    [u8  cbits  (context width, 0..8)]
    [u8  wlog   (requant window = 2^wlog steps, 0..3)]
    [K x u16 (or u32 if wide) per-lane payload sizes]
    [concatenated per-lane payloads, lane order]

At every step t with t % 2^wlog == 0 the model rescales (up to 3
conditional halvings) and requantizes; steps in between code against the
frozen tables while counts keep accumulating. The model is conditioned on
ctx = prev_symbol >> (8 - cbits), where prev_symbol is the same lane's
symbol one step earlier (0 at the first step).

Lane layout is CHUNKED: lane i owns the contiguous bytes
x[i*stride : (i+1)*stride] with stride = ceil(n / K), and codes its j-th
byte at step j, so the previous step's symbol is the true previous byte.
At step j the active lanes are the prefix {i : i*stride + j < n}.
"""

from __future__ import annotations

import numpy as np

from cpprcoder_tpu_torch.core.bytesutil import ByteReader, ByteWriter, as_u8
from cpprcoder_tpu_torch.models.cxmodel import (
    QBITS,
    QTOTAL,
    WLOG_DEFAULT,
    ctx_of,
    quantize_rows_np,
    rcx_params,
    rescale_rows_np,
    update_rows_np,
)
from cpprcoder_tpu_torch.reference.rc_ref import (
    LaneDecoder,
    LaneEncoder,
    _lane_desc,
    _parse_lane_desc,
    _write_sizes,
)


def rcx_encode(data, lanes: int | None = None, inc: int | None = None,
               climit_log2: int | None = None,
               cbits: int | None = None,
               wlog: int | None = None) -> bytes:
    x = as_u8(data)
    n = len(x)
    k, inc0, cl0, cb0 = rcx_params(n, lanes, inc, cbits)
    inc = inc if inc is not None else inc0
    climit_log2 = climit_log2 if climit_log2 is not None else cl0
    cbits = cbits if cbits is not None else cb0
    wlog = wlog if wlog is not None else WLOG_DEFAULT
    assert 0 <= wlog <= 3
    w = ByteWriter().u32(n)
    if n == 0:
        return (w.u8(_lane_desc(k, False)).u8(inc).u8(climit_log2)
                .u8(QBITS).u8(cbits).u8(wlog).getvalue())
    climit = 1 << climit_log2
    W = 1 << wlog
    stride = -(-n // k)
    pad = np.zeros(k * stride, np.uint8)
    pad[:n] = x
    cols = pad.reshape(k, stride).T          # [stride, k] chunked lanes
    encs = [LaneEncoder() for _ in range(k)]
    C = np.ones((1 << cbits, 256), np.uint32)
    prev = np.zeros(k, np.uint8)
    q = cums = None
    for t_idx in range(stride):
        if t_idx % W == 0:
            C = rescale_rows_np(C, climit)
            q = quantize_rows_np(C)
            cums = np.concatenate(
                [np.zeros((1 << cbits, 1), np.uint32),
                 np.cumsum(q[:, :255], axis=1, dtype=np.uint32)], axis=1)
        n_active = -(-(n - t_idx) // stride)     # active lanes are a prefix
        syms = cols[t_idx, :n_active]
        ctx = np.asarray(ctx_of(prev[:n_active], cbits), np.int64)
        for i in range(n_active):
            e = encs[i]
            s = int(syms[i])
            r = int(ctx[i])
            e.encode(int(cums[r, s]), int(q[r, s]), QTOTAL,
                     e.range >> QBITS)
        C = update_rows_np(C, ctx, syms.astype(np.int64), inc)
        prev[:n_active] = syms
    payloads = [e.finish() for e in encs]
    sizes = [len(p) for p in payloads]
    wide = max(sizes) >= 1 << 16
    w.u8(_lane_desc(k, wide)).u8(inc).u8(climit_log2).u8(QBITS).u8(cbits)
    w.u8(wlog)
    _write_sizes(w, sizes, wide)
    for p in payloads:
        w.raw(p)
    return w.getvalue()


def rcx_decode(blob) -> bytes:
    r = ByteReader(blob)
    n = r.u32()
    k, wide = _parse_lane_desc(r.u8())
    inc = r.u8()
    climit = 1 << r.u8()
    qbits = r.u8()
    cbits = r.u8()
    wlog = r.u8()
    assert qbits == QBITS, f"container qbits {qbits} != build {QBITS}"
    assert cbits <= 8, f"bad cbits {cbits}"
    assert wlog <= 3, f"bad wlog {wlog}"
    if n == 0:
        return b""
    W = 1 << wlog
    sizes = (r.u32s(k) if wide else r.u16s(k)).astype(np.int64)
    payload = r.rest()
    offsets = np.concatenate(([0], np.cumsum(sizes)))
    decs = [LaneDecoder(payload[offsets[j]:offsets[j + 1]]) for j in range(k)]
    stride = -(-n // k)
    out = np.zeros((stride, k), np.uint8)     # out[j, i] = x[i*stride + j]
    C = np.ones((1 << cbits, 256), np.uint32)
    prev = np.zeros(k, np.uint8)
    q = cums = None
    for t_idx in range(stride):
        if t_idx % W == 0:
            C = rescale_rows_np(C, climit)
            q = quantize_rows_np(C)
            cums = np.concatenate(
                [np.zeros((1 << cbits, 1), np.uint32),
                 np.cumsum(q[:, :255], axis=1, dtype=np.uint32)], axis=1)
        n_active = -(-(n - t_idx) // stride)
        ctx = np.asarray(ctx_of(prev[:n_active], cbits), np.int64)
        for i in range(n_active):
            d = decs[i]
            rr = int(ctx[i])
            t = d.range >> QBITS
            s = int(np.searchsorted(cums[rr] * t, d.code,
                                    side="right")) - 1
            d.consume(int(cums[rr, s]), int(q[rr, s]), QTOTAL, t)
            out[t_idx, i] = s
        syms = out[t_idx, :n_active]
        C = update_rows_np(C, ctx, syms.astype(np.int64), inc)
        prev[:n_active] = syms
    return out.T.reshape(-1)[:n].tobytes()
