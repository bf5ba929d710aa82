"""CT-RCX container path in PyTorch (counterpart of
cpprcoder_tpu/ops/rcx_ops.py, with the time-major branch of
range_ops._encode_container and the word rows of rcq_ops._rows_fn).

Format: cpprcoder_tpu/reference/rcx_ref.py. Lane i owns the contiguous
bytes x[i*stride:(i+1)*stride], stride = ceil(n/K), and codes its j-th byte
at step j; the model C[2^cbits, 256] is conditioned on the lane's previous
byte and requantized every 2^wlog steps.

`encode_events_plain` and `decode_symbols_plain` are the plain versions of
kernels A and C (ops/rcx_kernels.py): step loops over int64 lane vectors,
runnable on any device. `rcx_encode`/`rcx_decode` build containers around
the kernel wrappers, so the same code runs the kernels on a CUDA device
and the plain versions on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from cpprcoder_tpu.config import MASK32, RC_TOP
from cpprcoder_tpu.core.bytesutil import (
    ByteReader,
    ByteWriter,
    CorruptContainerError,
    as_u8,
)
from cpprcoder_tpu.reference.rc_ref import _lane_desc, _parse_lane_desc, _write_sizes
from cpprcoder_tpu_torch.models.cxmodel import (
    QBITS,
    QTOTAL,
    WLOG_DEFAULT,
    model_tables,
    rcx_params,
)
from cpprcoder_tpu_torch.ops import compaction, rc_common

N_SLOTS = 2   # range_new >= t >= 2^(24-QBITS) = 2^9: <= 2 renorms a step


def pad2d_chunked(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """x [n] uint8 -> x2d [stride, k] with x2d[j, i] = x[i*stride + j]
    (zero past the end)."""
    buf = torch.zeros(k * stride, dtype=torch.uint8, device=x.device)
    buf[: x.numel()] = x
    return buf.view(k, stride).T.contiguous()


def lane_lengths(n: int, k: int, stride: int, device) -> torch.Tensor:
    """Bytes each lane codes: clip(n - i*stride, 0, stride), int32 [k]."""
    lanes = torch.arange(k, dtype=torch.int64, device=device)
    return torch.clamp(n - lanes * stride, 0, stride).to(torch.int32)


# ------------------------------------------------------------------ encode

def encode_events_plain(x2d: torch.Tensor, lane_len: torch.Tensor, inc: int,
                        climit: int, cbits: int, wlog: int) -> torch.Tensor:
    """Plain version of kernel A: x2d [stride, K] uint8 -> events
    [2*stride+2, K] int32 (u32 bits)."""
    stride, k = x2d.shape
    dev = x2d.device
    st = rc_common.make_state(k, dev)
    C = torch.ones((1 << cbits, 256), dtype=torch.int64, device=dev)
    prev = torch.zeros(k, dtype=torch.int64, device=dev)
    lens = lane_len.to(torch.int64)
    xs = x2d.to(torch.int64)
    events = torch.empty((2 * stride + 2, k), dtype=torch.int64, device=dev)
    q = cum = None
    for j in range(stride):
        if j % (1 << wlog) == 0:
            C, q, cum = model_tables(C, climit)
        sym = xs[j]
        active = j < lens
        ctx = prev >> (8 - cbits)
        c = cum[ctx, sym]
        f = q[ctx, sym]
        t = st[2] >> QBITS
        st, evs = rc_common.encode_symbol(st, t, c, f, (c + f) == QTOTAL,
                                          active, N_SLOTS)
        events[2 * j:2 * j + 2] = evs
        C.index_put_((ctx, sym), torch.where(active, inc, 0),
                     accumulate=True)
        prev = torch.where(active, sym, prev)
    events[2 * stride:] = rc_common.flush(st)
    return rc_common.u32_to_i32(events)


def _header(n, k, wide, inc, climit_log2, cbits, wlog) -> ByteWriter:
    return (ByteWriter().u32(n).u8(_lane_desc(k, wide)).u8(inc)
            .u8(climit_log2).u8(QBITS).u8(cbits).u8(wlog))


def rcx_encode(data, lanes: int | None = None, inc: int | None = None,
               climit_log2: int | None = None, cbits: int | None = None,
               wlog: int | None = None, device="cpu") -> bytes:
    """CT-RCX container of `data`, coded on `device` (kernels on CUDA,
    plain versions on the CPU). Same parameters as rcx_ref.rcx_encode."""
    x = as_u8(data)
    n = len(x)
    k, inc0, cl0, cb0 = rcx_params(n, lanes, inc, cbits)
    inc = inc0 if inc is None else inc
    climit_log2 = cl0 if climit_log2 is None else climit_log2
    cbits = cb0 if cbits is None else cbits
    wlog = WLOG_DEFAULT if wlog is None else wlog
    if not (0 <= cbits <= 8 and 0 <= wlog <= 3):
        raise ValueError(f"cbits {cbits} must be 0..8 and wlog {wlog} 0..3")
    if n == 0:
        return _header(0, k, False, inc, climit_log2, cbits, wlog).getvalue()
    stride = -(-n // k)
    # a lane's pending run of 0xFF bytes must fit the event's 22-bit field
    if 3 * stride + 2 >= 1 << rc_common.EV_RUN_BITS:
        raise ValueError(f"{n} bytes over {k} lanes exceed one container "
                         f"(stride {stride}); split the input")
    from cpprcoder_tpu_torch.ops import expand, rcx_kernels

    xt = torch.from_numpy(x.copy()).to(device)
    events = rcx_kernels.encode_events(
        pad2d_chunked(xt, k, stride), lane_lengths(n, k, stride, xt.device),
        inc, 1 << climit_log2, cbits, wlog)
    rows, sizes = expand.materialize_rows(events)
    return assemble((n, k, inc, climit_log2, cbits, wlog),
                    rows.cpu().numpy(), sizes.cpu().numpy())


def assemble(params, rows: np.ndarray, sizes: np.ndarray) -> bytes:
    """Container for params (n, k, inc, climit_log2, cbits, wlog): header,
    size table (u32 "wide" when a lane payload reaches 64 KiB, else u16),
    then the first sizes[i] bytes of each row i."""
    sizes = sizes.astype(np.int64)
    payload = rows[np.arange(rows.shape[1])[None, :] < sizes[:, None]]
    wide = bool(sizes.max() >= 1 << 16)
    n, k, *rest = params
    w = _header(n, k, wide, *rest)
    _write_sizes(w, sizes.tolist(), wide)
    w.raw(payload.tobytes())
    return w.getvalue()


# ------------------------------------------------------------------ decode

def decode_symbols_plain(words: torch.Tensor, lane_len: torch.Tensor, n: int,
                         stride: int, inc: int, climit: int, cbits: int,
                         wlog: int) -> torch.Tensor:
    """Plain version of kernel C: words [l4, K] int32 (big-endian u32 word
    rows, word-major; zero past each lane's end) -> uint8 [n]."""
    l4, k = words.shape
    dev = words.device
    w = rc_common.i32_to_u32(words)
    zeros = torch.zeros(k, dtype=torch.int64, device=dev)
    rng = torch.full_like(zeros, MASK32)
    code = w[0].clone() if l4 else zeros.clone()
    q0, q1, occ = zeros.clone(), zeros.clone(), zeros.clone()
    widx = torch.ones_like(zeros)
    prev = zeros.clone()
    lanes = torch.arange(k, device=dev)
    lens = lane_len.to(torch.int64)
    C = torch.ones((1 << cbits, 256), dtype=torch.int64, device=dev)
    out = torch.zeros((k, stride), dtype=torch.uint8, device=dev)
    q = cum = None
    for j in range(stride):
        need = occ < N_SLOTS
        word = w[torch.clamp(widx, max=max(l4 - 1, 0)), lanes] if l4 else zeros
        word = torch.where(need & (widx < l4), word, 0)
        q0 = q0 | torch.where(occ == 0, word, word >> 8)
        q1 = q1 | torch.where(occ == 0, 0, (word << 24) & MASK32)
        occ = torch.where(need, occ + 4, occ)
        widx = widx + need.to(torch.int64)

        if j % (1 << wlog) == 0:
            C, q, cum = model_tables(C, climit)
        active = j < lens
        ctx = prev >> (8 - cbits)
        row_c = cum[ctx]                                   # [K, 256]
        t = rng >> QBITS
        sym = (row_c * t[:, None] <= code[:, None]).sum(dim=1) - 1
        c = row_c.gather(1, sym[:, None])[:, 0]
        f = q[ctx, sym]
        code = (code - c * t) & MASK32
        rng = torch.where((c + f) == QTOTAL, (rng - c * t) & MASK32,
                          (f * t) & MASK32)
        for _ in range(N_SLOTS):
            do = rng < RC_TOP
            b = q0 >> 24
            q0 = torch.where(do, ((q0 << 8) & MASK32) | (q1 >> 24), q0)
            q1 = torch.where(do, (q1 << 8) & MASK32, q1)
            occ = occ - do.to(torch.int64)
            code = torch.where(do, ((code << 8) & MASK32) | b, code)
            rng = torch.where(do, (rng << 8) & MASK32, rng)
        C.index_put_((ctx, sym), torch.where(active, inc, 0),
                     accumulate=True)
        prev = torch.where(active, sym, prev)
        out[:, j] = sym.to(torch.uint8)
    return out.reshape(-1)[:n]


def parse_rcx_header(r: ByteReader):
    """-> (n, k, wide, inc, climit_log2, cbits, wlog); rejects a qbits
    other than QBITS, cbits > 8 and wlog > 3."""
    n = r.u32()
    k, wide = _parse_lane_desc(r.u8())
    inc = r.u8()
    climit_log2 = r.u8()
    qbits = r.u8()
    cbits = r.u8()
    wlog = r.u8()
    if qbits != QBITS:
        raise CorruptContainerError(
            f"container qbits {qbits} != build {QBITS}")
    if cbits > 8:
        raise CorruptContainerError(f"bad cbits {cbits}")
    if wlog > 3:
        raise CorruptContainerError(f"bad wlog {wlog}")
    return n, k, wide, inc, climit_log2, cbits, wlog


def word_rows(payload: torch.Tensor, sizes: torch.Tensor,
              l4: int) -> torch.Tensor:
    """Flat lane-ordered payload [P] uint8 + lane sizes [K] -> [l4, K]
    int32 big-endian u32 word rows, word-major (word j of lane i = lane
    bytes 4j..4j+3, zero past its end)."""
    sizes = sizes.to(torch.int64)
    col = torch.arange(4 * l4, device=payload.device)
    rows = torch.zeros((sizes.numel(), 4 * l4), dtype=torch.uint8,
                       device=payload.device)
    if payload.numel():
        starts = torch.cumsum(sizes, 0) - sizes
        idx = torch.clamp(starts[:, None] + col[None, :],
                          max=payload.numel() - 1)
        rows = torch.where(col[None, :] < sizes[:, None], payload[idx], rows)
    return compaction.rows_to_be_words(rows).T.contiguous()


def rcx_decode(blob, device="cpu") -> bytes:
    r = ByteReader(blob)
    n, k, wide, inc, climit_log2, cbits, wlog = parse_rcx_header(r)
    if n == 0:
        return b""
    sizes = (r.u32s(k) if wide else r.u16s(k)).astype(np.int64)
    payload = r.rest()
    if int(sizes.sum()) > len(payload):
        raise CorruptContainerError(
            f"size table claims {int(sizes.sum())} payload bytes, "
            f"container has {len(payload)}")
    from cpprcoder_tpu_torch.ops import rcx_kernels

    stride = -(-n // k)
    l4 = -(-int(sizes.max()) // 4) + 1
    words = word_rows(torch.from_numpy(payload.copy()).to(device),
                      torch.from_numpy(sizes).to(device), l4)
    out = rcx_kernels.decode_symbols(
        words, lane_lengths(n, k, stride, words.device), n, stride, inc,
        1 << climit_log2, cbits, wlog)
    return out.cpu().numpy().tobytes()
