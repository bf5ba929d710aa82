"""CT-RC1 (static) and CT-RC2 (adaptive) container paths in PyTorch
(counterpart of cpprcoder_tpu/ops/range_ops.py).

Format: reference/rc_ref.py. K interleaved lanes: lane i codes x[j*K + i]
at step j, for the stride = ceil(n/K) steps (the JAX package pads the steps
to `bucket(stride)`; its pad steps are inactive and change no state, so
the bytes are the same). CT-RC1 codes against one static table of total
2^16 (t = range >> 16), normalized from the input's histogram on the host
(models/static_table.py) and written into the header (models/freq_header).
CT-RC2 keeps one adaptive model freqs[256] for all lanes: before each step,
freqs = (freqs >> 1) | 1 while the total has reached 2^limit_log2; every
lane codes its step's symbol against the same table (t = range / total);
then each active lane adds inc to its symbol's count, so encoder and
decoder see the same tables.

The coder is kernel J (encode, ops/range_kernels.py) and kernel L
(decode); J's events become the lanes' payload rows through kernel B
(ops/expand.py), where the JAX package expands them with XLA
(`compaction.materialize`). The plain step loops below are the kernels'
plain versions: on CPU tensors the wrappers run them.

Events: time-major [n_slots*stride + 2, K], n_slots shift_low slots a
step, then 2 flush rows. `slots` gives n_slots: 2 for CT-RC1, and for
CT-RC2 2 only where its coding total provably stays at or below 2^16
(max(2^limit_log2 - 1, K*inc + 512) <= 2^16), else 3. The JAX package's
rule, 2 whenever limit_log2 <= 16, writes wrong bytes once K*inc passes
about 2^16 (ROADMAP C6). The decoder feeds each lane from its big-endian
word row through a byte queue (bytes past the lane's end read as zero, as
`_queue_refill` does): a whole word joins the queue whenever fewer than
n_slots bytes are buffered.
"""

from __future__ import annotations

import numpy as np
import torch

from cpprcoder_tpu_torch.config import (
    MASK32,
    RC_TOP,
    STATIC_TOTAL,
    STATIC_TOTAL_BITS,
    adaptive_params_for,
    pick_lanes,
)
from cpprcoder_tpu_torch.core.bytesutil import ByteReader, ByteWriter, as_u8
from cpprcoder_tpu_torch.models.freq_header import pack_freqs, read_freqs
from cpprcoder_tpu_torch.models.static_table import normalize_freqs
from cpprcoder_tpu_torch.ops import layout, rc_common
from cpprcoder_tpu_torch.reference.rc_ref import _lane_desc, _parse_lane_desc

STATIC_SLOTS = 2   # total 2^16: t >= 2^8, so at most 2 shifts a symbol


def total_bound(k: int, inc: int, limit_log2: int) -> int:
    """B = max(2^limit_log2 - 1, K*inc + 512): no CT-RC2 step of K lanes
    codes against a total above B.

    By induction over the steps. Step 0 codes against 256 <= B. Before step
    j + 1 the total is P = T + a*inc, with T <= B the total of step j and
    a <= K its active lanes. If P < 2^limit it is kept, and P <= 2^limit - 1
    <= B. Else every count f becomes (f >> 1) | 1 <= f/2 + 1, so the new
    total is at most P/2 + 256 <= (B + K*inc)/2 + 256 <= B, since K*inc +
    512 <= B."""
    return max((1 << limit_log2) - 1, k * inc + 512)


def slots(freqs, limit_log2: int, k: int, inc: int) -> int:
    """shift_low slots a step for K lanes: 2 for CT-RC1 (freqs given: total
    2^16); for CT-RC2 2 where total_bound(K, inc, limit_log2) <= 2^16,
    else 3.

    A step leaves range >= t*f with t = floor(range/total) and f >= 1 (the
    top symbol keeps range - t*c >= t*f too). With range >= 2^24 and total
    <= 2^16, t >= 2^8, so two shifts bring range back to 2^24; with total
    < 2^24, t >= 1 and three shifts do. A total of 2^24 or more (B >= 2^24
    needs limit_log2 >= 25) can give t = 0, where the oracle never ends
    (ROADMAP C7): 3 there too, and nothing is claimed."""
    if freqs is not None:
        return STATIC_SLOTS
    return 2 if total_bound(k, inc, limit_log2) <= 1 << 16 else 3


def _step_model(freqs: torch.Tensor, limit: int):
    """CT-RC2's table before a step: rescaled while the total has reached
    the limit (one halving, as range_ops.py:108-111). -> (freqs, total,
    exclusive cum), int64."""
    freqs = torch.where(freqs.sum() >= limit, (freqs >> 1) | 1, freqs)
    return freqs, freqs.sum(), torch.cumsum(freqs, 0) - freqs


def encode_events_plain(x2d: torch.Tensor, lane_len: torch.Tensor,
                        freqs: torch.Tensor | None, inc: int,
                        limit_log2: int) -> torch.Tensor:
    """Plain version of kernel J: x2d [stride, K] uint8 (x2d[j, i] =
    x[j*K + i]) -> events [n_slots*stride + 2, K] int32 (u32 bits). Lane i
    codes x2d[j, i] for j < lane_len[i]. freqs: CT-RC1's static table
    (int32 [256], total 2^16), or None for CT-RC2's adaptive model."""
    stride, k = x2d.shape
    dev = x2d.device
    n_slots = slots(freqs, limit_log2, k, inc)
    st = rc_common.make_state(k, dev)
    lens = lane_len.to(torch.int64)
    xs = x2d.to(torch.int64)
    events = torch.empty((n_slots * stride + 2, k), dtype=torch.int64,
                         device=dev)
    if freqs is not None:
        f_tab = freqs.to(torch.int64)
        total = torch.tensor(STATIC_TOTAL, dtype=torch.int64, device=dev)
        cum = torch.cumsum(f_tab, 0) - f_tab
    else:
        f_tab = torch.ones(256, dtype=torch.int64, device=dev)
    for j in range(stride):
        if freqs is None:
            f_tab, total, cum = _step_model(f_tab, 1 << limit_log2)
        sym = xs[j]
        active = j < lens
        c, f = cum[sym], f_tab[sym]
        t = st[2] >> STATIC_TOTAL_BITS if freqs is not None else st[2] // total
        st, evs = rc_common.encode_symbol(st, t, c, f, (c + f) == total,
                                          active, n_slots)
        events[n_slots * j:n_slots * (j + 1)] = evs
        if freqs is None:
            f_tab = f_tab.index_add(0, sym, torch.where(active, inc, 0))
    events[n_slots * stride:] = rc_common.flush(st)
    return rc_common.u32_to_i32(events)


def decode_symbols_plain(words: torch.Tensor, lane_len: torch.Tensor, n: int,
                         stride: int, freqs: torch.Tensor | None, inc: int,
                         limit_log2: int) -> torch.Tensor:
    """Plain version of kernel L: words [l4, K] int32 big-endian u32 word
    rows (word-major, l4 >= 1) -> the n decoded bytes, uint8 [n] (byte
    j*K + i is lane i's step j). freqs as for encode_events_plain."""
    l4, k = words.shape
    dev = words.device
    n_slots = slots(freqs, limit_log2, k, inc)
    w = rc_common.i32_to_u32(words)
    zero = torch.zeros(k, dtype=torch.int64, device=dev)
    rng = torch.full((k,), MASK32, dtype=torch.int64, device=dev)
    code = w[0]
    q = zero.clone()      # the queued bytes, the oldest highest
    occ = zero.clone()    # how many
    widx = torch.ones_like(zero)
    lens = lane_len.to(torch.int64)
    out = torch.zeros((stride, k), dtype=torch.uint8, device=dev)
    lane = torch.arange(k, device=dev)
    if freqs is not None:
        f_tab = freqs.to(torch.int64)
        total = torch.tensor(STATIC_TOTAL, dtype=torch.int64, device=dev)
        cum = torch.cumsum(f_tab, 0) - f_tab
    else:
        f_tab = torch.ones(256, dtype=torch.int64, device=dev)
    for j in range(stride):
        if freqs is None:
            f_tab, total, cum = _step_model(f_tab, 1 << limit_log2)
        active = j < lens
        need = active & (occ < n_slots)
        word = torch.where(widx < l4, w[torch.clamp(widx, max=l4 - 1), lane],
                           0)
        q = torch.where(need, (q << 32) | word, q)
        occ = torch.where(need, occ + 4, occ)
        widx = torch.where(need, widx + 1, widx)
        t = rng >> STATIC_TOTAL_BITS if freqs is not None else rng // total
        v = torch.minimum(code // t, total - 1)
        sym = torch.searchsorted(cum, v, right=True) - 1
        c, f = cum[sym], f_tab[sym]
        code2 = code - t * c
        rng2 = torch.where((c + f) == total, rng - t * c, t * f)
        occ2 = occ
        for _ in range(n_slots):
            do = rng2 < RC_TOP
            occ2 = occ2 - do.to(torch.int64)
            byte = (q >> (8 * torch.clamp(occ2, min=0))) & 0xFF
            code2 = torch.where(do, ((code2 << 8) | byte) & MASK32, code2)
            rng2 = torch.where(do, (rng2 << 8) & MASK32, rng2)
        q2 = q & (torch.bitwise_left_shift(torch.ones_like(occ2), 8 * occ2) - 1)
        rng, code, q, occ = (torch.where(active, a, b) for a, b in
                             ((rng2, rng), (code2, code), (q2, q),
                              (occ2, occ)))
        out[j] = torch.where(active, sym, 0).to(torch.uint8)
        if freqs is None:
            f_tab = f_tab.index_add(0, sym, torch.where(active, inc, 0))
    return out.reshape(-1)[:n]


# ------------------------------------------------------------ containers

def static_header(n, k, wide, freqs=None) -> ByteWriter:
    """CT-RC1 header: u32 n, lane_desc, then (n > 0) the packed table."""
    w = ByteWriter().u32(n).u8(_lane_desc(k, wide))
    return w if freqs is None else w.raw(pack_freqs(freqs))


def adaptive_header(n, k, wide, inc, limit_log2) -> ByteWriter:
    """CT-RC2 header: u32 n, lane_desc, inc, limit_log2."""
    return ByteWriter().u32(n).u8(_lane_desc(k, wide)).u8(inc).u8(limit_log2)


def _encode(x: np.ndarray, k: int, freqs, inc: int, limit_log2: int,
            head, device) -> bytes:
    """Code x over K interleaved lanes on `device` (J, then B) and build
    the container: head(wide), the size table, the lane payloads."""
    from cpprcoder_tpu_torch.ops import expand, range_kernels

    n = len(x)
    stride = -(-n // k)
    # a lane's pending run of 0xFF bytes must fit the event's 22-bit field
    if 3 * stride + 2 >= 1 << rc_common.EV_RUN_BITS:
        raise ValueError(f"{n} bytes over {k} lanes exceed one container "
                         f"(stride {stride}); split the input")
    xt = torch.from_numpy(x.copy()).to(device)
    ft = None if freqs is None else \
        torch.from_numpy(freqs.astype(np.int32)).to(device)
    events = range_kernels.encode_events(
        layout.pad2d_interleaved(xt, k, stride),
        layout.lane_lengths_interleaved(n, k, stride, xt.device),
        ft, inc, limit_log2)
    rows, sizes = expand.materialize_rows(events)
    return layout.assemble(head, rows.cpu().numpy(), sizes.cpu().numpy())


def _decode(r: ByteReader, n: int, k: int, wide: bool, freqs, inc: int,
            limit_log2: int, device) -> bytes:
    from cpprcoder_tpu_torch.ops import range_kernels

    stride = -(-n // k)
    words = layout.payload_words(r, k, wide, device)
    ft = None if freqs is None else \
        torch.from_numpy(freqs.astype(np.int32)).to(words.device)
    out = range_kernels.decode_symbols(
        words, layout.lane_lengths_interleaved(n, k, stride, words.device),
        n, stride, ft, inc, limit_log2)
    return out.cpu().numpy().tobytes()


def static_encode(data, lanes: int | None = None, *, device) -> bytes:
    """CT-RC1 container of `data`, coded on `device` (kernels on CUDA,
    plain versions on the CPU). Same parameters as rc_ref.static_encode."""
    x = as_u8(data)
    n = len(x)
    k = lanes or pick_lanes(n)
    if n == 0:
        return static_header(0, k, False).getvalue()
    freqs = normalize_freqs(np.bincount(x, minlength=256), STATIC_TOTAL_BITS)
    return _encode(x, k, freqs, 0, 16,
                   lambda wide: static_header(n, k, wide, freqs), device)


def static_decode(blob, *, device) -> bytes:
    r = ByteReader(blob)
    n = r.u32()
    k, wide = _parse_lane_desc(r.u8())
    if n == 0:
        return b""
    freqs = read_freqs(r, STATIC_TOTAL)
    return _decode(r, n, k, wide, freqs, 0, 16, device)


def adaptive_encode(data, lanes: int | None = None, inc: int | None = None,
                    limit_log2: int | None = None, *, device) -> bytes:
    """CT-RC2 container of `data`, coded on `device`. Same parameters as
    rc_ref.adaptive_encode."""
    x = as_u8(data)
    n = len(x)
    k = lanes or pick_lanes(n)
    inc0, limit0 = adaptive_params_for(k)
    inc = inc0 if inc is None else inc
    limit_log2 = limit0 if limit_log2 is None else limit_log2
    if n == 0:
        return adaptive_header(0, k, False, inc, limit_log2).getvalue()
    return _encode(x, k, None, inc, limit_log2,
                   lambda wide: adaptive_header(n, k, wide, inc, limit_log2),
                   device)


def adaptive_decode(blob, *, device) -> bytes:
    r = ByteReader(blob)
    n = r.u32()
    k, wide = _parse_lane_desc(r.u8())
    inc = r.u8()
    limit_log2 = r.u8()
    if n == 0:
        return b""
    return _decode(r, n, k, wide, None, inc, limit_log2, device)
