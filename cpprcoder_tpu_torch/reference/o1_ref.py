"""Oracle (host, exact) implementation of CT-RC3 (FORMATS.md; the port's own
copy of cpprcoder_tpu/reference/o1_ref.py).

Order-1 blended adaptive range coder: chunked lanes (each lane's context is
its own previous byte), shared order-1 + order-0 models blended with exact
integer weights. Goes beyond the reference's order-0 coder — context
modeling is the standard way to beat a converged order-0 coder on text.
Vectorized numpy per step (K lanes at a time) so corpus-size files are
testable."""

from __future__ import annotations

import numpy as np

from cpprcoder_tpu_torch.config import pick_lanes
from cpprcoder_tpu_torch.core.bytesutil import ByteReader, ByteWriter, as_u8
from cpprcoder_tpu_torch.reference.rc_ref import (
    LaneDecoder,
    LaneEncoder,
    _lane_desc,
    _parse_lane_desc,
    _write_sizes,
)

LIMIT1_LOG2 = 11
LIMIT0_LOG2 = 15
BLEND_LOG2 = 5


def pick_inc(k: int) -> int:
    return max(1, min(32, (1 << 13) // k))


def _chunk_layout(n: int, k: int):
    L = -(-n // k) if n else 1
    lens = np.clip(n - np.arange(k) * L, 0, L)
    return L, lens


def o1_encode(data, lanes: int | None = None, inc: int | None = None,
              limit1_log2: int = LIMIT1_LOG2, limit0_log2: int = LIMIT0_LOG2,
              blend_log2: int = BLEND_LOG2) -> bytes:
    x = as_u8(data)
    n = len(x)
    k = lanes or pick_lanes(n)
    inc = inc if inc is not None else pick_inc(k)
    w = ByteWriter().u32(n)
    if n == 0:
        return (w.u8(_lane_desc(k, False)).u8(inc).u8(limit1_log2)
                .u8(limit0_log2).u8(blend_log2).getvalue())
    L, lens = _chunk_layout(n, k)
    A = 1 << blend_log2
    t1 = np.ones((256, 256), np.int64)
    rowtot = np.full(256, 256, np.int64)
    t0 = np.ones(256, np.int64)
    tot0 = 256
    encs = [LaneEncoder() for _ in range(k)]
    ctx = np.zeros(k, np.int64)
    lane_idx = np.arange(k)
    for t in range(L):
        resc1 = rowtot >= (1 << limit1_log2)
        if resc1.any():
            rows = np.nonzero(resc1)[0]
            t1[rows] = (t1[rows] >> 1) | 1
            rowtot[rows] = t1[rows].sum(axis=1)
        if tot0 >= (1 << limit0_log2):
            t0 = (t0 >> 1) | 1
            tot0 = int(t0.sum())
        active = np.nonzero(t < lens)[0]
        if len(active) == 0:
            break
        c0 = np.concatenate(([0], np.cumsum(t0[:-1])))
        syms = x[active * L + t].astype(np.int64)
        actx = ctx[active]
        rows1 = t1[actx]                              # [a, 256]
        c1 = np.cumsum(rows1, axis=1) - rows1         # exclusive
        f_eff = A * rows1[np.arange(len(active)), syms] + t0[syms]
        c_eff = A * c1[np.arange(len(active)), syms] + c0[syms]
        tot_eff = A * rowtot[actx] + tot0
        for i, j in enumerate(active):
            e = encs[j]
            e.encode(int(c_eff[i]), int(f_eff[i]), int(tot_eff[i]),
                     e.range // int(tot_eff[i]))
        np.add.at(t1, (actx, syms), inc)
        np.add.at(rowtot, actx, inc)
        np.add.at(t0, syms, inc)
        tot0 += inc * len(active)
        ctx[active] = syms
    payloads = [e.finish() for e in encs]
    sizes = [len(p) for p in payloads]
    wide = max(sizes) >= 1 << 16
    (w.u8(_lane_desc(k, wide)).u8(inc).u8(limit1_log2).u8(limit0_log2)
     .u8(blend_log2))
    _write_sizes(w, sizes, wide)
    for p in payloads:
        w.raw(p)
    return w.getvalue()


def o1_decode(blob) -> bytes:
    r = ByteReader(blob)
    n = r.u32()
    k, wide = _parse_lane_desc(r.u8())
    inc = r.u8()
    limit1 = 1 << r.u8()
    limit0 = 1 << r.u8()
    A = 1 << r.u8()
    if n == 0:
        return b""
    sizes = (r.u32s(k) if wide else r.u16s(k)).astype(np.int64)
    payload = r.rest()
    offsets = np.concatenate(([0], np.cumsum(sizes)))
    decs = [LaneDecoder(payload[offsets[j]:offsets[j + 1]]) for j in range(k)]
    L, lens = _chunk_layout(n, k)
    t1 = np.ones((256, 256), np.int64)
    rowtot = np.full(256, 256, np.int64)
    t0 = np.ones(256, np.int64)
    tot0 = 256
    ctx = np.zeros(k, np.int64)
    out = np.zeros(n, np.uint8)
    for t in range(L):
        resc1 = rowtot >= limit1
        if resc1.any():
            rows = np.nonzero(resc1)[0]
            t1[rows] = (t1[rows] >> 1) | 1
            rowtot[rows] = t1[rows].sum(axis=1)
        if tot0 >= limit0:
            t0 = (t0 >> 1) | 1
            tot0 = int(t0.sum())
        active = np.nonzero(t < lens)[0]
        if len(active) == 0:
            break
        c0_incl = np.cumsum(t0)
        syms = np.zeros(len(active), np.int64)
        actx = ctx[active]
        rows1 = t1[actx]
        cum_eff_incl = A * np.cumsum(rows1, axis=1) + c0_incl[None, :]
        for i, j in enumerate(active):
            d = decs[j]
            tot_eff = int(A * rowtot[actx[i]] + tot0)
            tt = d.range // tot_eff
            v = min(d.code // tt, tot_eff - 1)
            s = int(np.searchsorted(cum_eff_incl[i], v, side="right"))
            f_eff = int(cum_eff_incl[i][s] - (cum_eff_incl[i][s - 1] if s else 0))
            c_eff = int(cum_eff_incl[i][s - 1]) if s else 0
            out[j * L + t] = s
            syms[i] = s
            d.consume(c_eff, f_eff, tot_eff, tt)
        np.add.at(t1, (actx, syms), inc)
        np.add.at(rowtot, actx, inc)
        np.add.at(t0, syms, inc)
        tot0 += inc * len(active)
        ctx[active] = syms
    return out.tobytes()
