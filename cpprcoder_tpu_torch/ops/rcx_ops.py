"""CT-RCX container path in PyTorch (counterpart of
cpprcoder_tpu/ops/rcx_ops.py, with the time-major branch of
range_ops._encode_container).

Format: reference/rcx_ref.py. Lane i owns the contiguous
bytes x[i*stride:(i+1)*stride], stride = ceil(n/K), and codes its j-th byte
at step j; the model C[2^cbits, 256] is conditioned on the lane's previous
byte and requantized every 2^wlog steps.

`encode_events_plain` and `decode_symbols_plain` are the plain versions of
kernels A and C (ops/rcx_kernels.py): step loops over int64 lane vectors,
runnable on any device. With one context, a requant every step, one
halving and the interleaved layout they are also the plain versions of
CT-RCQ's kernels D and E (ops/rcq_ops.py). `rcx_encode`/`rcx_decode` build
containers around the kernel wrappers, so the same code runs the kernels
on a CUDA device and the plain versions on the CPU; the lane layout and
the container pieces are ops/layout.py's.
"""

from __future__ import annotations

import torch

from cpprcoder_tpu_torch.config import MASK32, RC_TOP
from cpprcoder_tpu_torch.core.bytesutil import (
    ByteReader,
    ByteWriter,
    CorruptContainerError,
    as_u8,
)
from cpprcoder_tpu_torch.models.cxmodel import (
    QBITS,
    QTOTAL,
    RESCALE_ROUNDS,
    WLOG_DEFAULT,
    model_tables,
    rcx_params,
)
from cpprcoder_tpu_torch.ops import layout, rc_common
from cpprcoder_tpu_torch.reference.rc_ref import _lane_desc, _parse_lane_desc

N_SLOTS = 2   # range_new >= t >= 2^(24-QBITS) = 2^9: <= 2 renorms a step


# ------------------------------------------------------------------ encode

def encode_events_plain(x2d: torch.Tensor, lane_len: torch.Tensor, inc: int,
                        climit: int, cbits: int, wlog: int,
                        rounds: int = RESCALE_ROUNDS) -> torch.Tensor:
    """Plain version of kernels A and D: x2d [stride, K] uint8 -> events
    [2*stride+2, K] int32 (u32 bits). Lane i codes x2d[j, i] for
    j < lane_len[i]; `rounds` halvings at most per requant."""
    k = x2d.shape[1]
    dev = x2d.device
    C = torch.ones((1 << cbits, 256), dtype=torch.int64, device=dev)
    st, _, events = encode_steps_plain(x2d, lane_len, rc_common.make_state(
        k, dev), C, inc, climit, cbits, wlog, rounds)
    return rc_common.u32_to_i32(torch.cat([events, rc_common.flush(st)]))


def encode_steps_plain(x2d: torch.Tensor, lane_len: torch.Tensor, st, C,
                       inc: int, climit: int, cbits: int, wlog: int,
                       rounds: int):
    """The step loop of encode_events_plain from a given coder state (the
    five int64 lane vectors of rc_common.make_state) and model C [2^cbits,
    256] int64, with no flush: -> (state, C, events [2*stride, K] int64).
    The C returned is the counts after the last step's updates, not
    requantized (a requant opens each window)."""
    stride, k = x2d.shape
    dev = x2d.device
    prev = torch.zeros(k, dtype=torch.int64, device=dev)
    lens = lane_len.to(torch.int64)
    xs = x2d.to(torch.int64)
    events = torch.empty((2 * stride, k), dtype=torch.int64, device=dev)
    q = cum = None
    for j in range(stride):
        if j % (1 << wlog) == 0:
            C, q, cum = model_tables(C, climit, rounds)
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
    return st, C, events


def header(n, k, wide, inc, climit_log2, cbits, wlog) -> ByteWriter:
    """CT-RCX header: u32 n, lane_desc, inc, climit_log2, QBITS, cbits,
    wlog."""
    return (ByteWriter().u32(n).u8(_lane_desc(k, wide)).u8(inc)
            .u8(climit_log2).u8(QBITS).u8(cbits).u8(wlog))


def rcx_encode(data, lanes: int | None = None, inc: int | None = None,
               climit_log2: int | None = None, cbits: int | None = None,
               wlog: int | None = None, *, device) -> bytes:
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
        return header(0, k, False, inc, climit_log2, cbits, wlog).getvalue()
    stride = -(-n // k)
    # a lane's pending run of 0xFF bytes must fit the event's 22-bit field
    if 3 * stride + 2 >= 1 << rc_common.EV_RUN_BITS:
        raise ValueError(f"{n} bytes over {k} lanes exceed one container "
                         f"(stride {stride}); split the input")
    from cpprcoder_tpu_torch.ops import expand, rcx_kernels

    xt = torch.from_numpy(x.copy()).to(device)
    events = rcx_kernels.encode_events(
        layout.pad2d_chunked(xt, k, stride),
        layout.lane_lengths(n, k, stride, xt.device),
        inc, rc_common.climit_u32(climit_log2, n, inc), cbits, wlog)
    rows, sizes = expand.materialize_rows(events)
    return layout.assemble(
        lambda wide: header(n, k, wide, inc, climit_log2, cbits, wlog),
        rows.cpu().numpy(), sizes.cpu().numpy())


# ------------------------------------------------------------------ decode

def decode_symbols_plain(words: torch.Tensor, lane_len: torch.Tensor, n: int,
                         stride: int, inc: int, climit: int, cbits: int,
                         wlog: int, rounds: int = RESCALE_ROUNDS,
                         interleaved: bool = False) -> torch.Tensor:
    """Plain version of kernels C and E: words [l4, K] int32 (big-endian
    u32 word rows, word-major; zero past each lane's end) -> uint8 [n].
    Lane i's step-j byte is byte i*stride + j, or j*K + i if
    `interleaved`."""
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
            C, q, cum = model_tables(C, climit, rounds)
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
    return (out.T if interleaved else out).reshape(-1)[:n]


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


def rcx_decode(blob, *, device) -> bytes:
    r = ByteReader(blob)
    n, k, wide, inc, climit_log2, cbits, wlog = parse_rcx_header(r)
    if n == 0:
        return b""
    from cpprcoder_tpu_torch.ops import rcx_kernels

    stride = -(-n // k)
    words = layout.payload_words(r, k, wide, device)
    out = rcx_kernels.decode_symbols(
        words, layout.lane_lengths(n, k, stride, words.device), n, stride,
        inc, rc_common.climit_u32(climit_log2, n, inc), cbits, wlog)
    return out.cpu().numpy().tobytes()
