"""CT-ANS2 container path in PyTorch (counterpart of
cpprcoder_tpu/ops/ans2_ops.py).

Format: reference/ans2_ref.py. K interleaved lanes (lane j codes x[t*K + j]
at step t, CT-ANS1's layout: layout.pad2d_interleaved and
layout.lane_lengths_interleaved) share one adaptive model. Its counts start
at 1 and every coded symbol adds inc to its own; a coding table (f,
exclusive c), normalized to 2^14 by the CT largest-remainder spec
(models/static_table.normalize_freqs), is taken at each window start, after
the rescale counts = (counts >> 1) | 1 wherever the total has reached
2^limit_log2. Windows start at step 0, at every power of two below
R = 2^refresh_log2 and at every multiple of R; step t codes with snapshot
`snapshot_index(t, R)`.

Encode is two device passes, decode one:
  W  the model (`window_tables`): each window's histogram, the rescale walk
     over the windows, each window's normalize -> tables [n_snap, 256] as
     the entries X reads, (rcp, f | c << 16) packed in an int64, rcp =
     floor((2^32 - 1) / f) (`table_entries`; `entry_tables` gives back (f,
     c));
  X  the coder (`encode_events`): CT-ANS1's reverse interleaved rANS, step t
     reading its window's entry by index (the JAX package's pass B, a
     one-hot matrix product, has no counterpart: Mosaic has no gather, the
     card has one). Its events [steps, K] are (emit << 16) | (st & 0xFFFF),
     time-major, so the stream in the decoder's read order is
     `ev.reshape(-1)[emit] & 0xFFFF`: step-major, then lane-major, which is
     the oracle's `emitted[::-1]`;
  Y  the decode (`decode_symbols`): all lanes share the model and the one
     word stream, so a step's refilling lanes take words base + #(refilling
     lanes before them) in lane order.

The counts and the total are 64-bit in every version here, as the oracle's
int64 counts and Python-int total: exact at every header value. (The JAX
package keeps them as u32 and cannot take limit_log2 >= 32: ROADMAP C10.)
Shifts by a header byte are clamped where they stop mattering: the total
never reaches 2^63 (n < 2^32, inc < 2^8), and a refresh_log2 at or past
bitlen(steps - 1) makes every window a warm-up window (`refresh_eff`).

`window_tables_plain`, `encode_events_plain` and `decode_symbols_plain` are
the kernels' plain versions (ops/ans2_kernels.py), and
`normalize_tables_plain` that of the normalize W and Y share (the spec,
normalize_freqs, row by row). `normalize_sorted_plain` is the kernels'
formulation of it, a sort of packed unique keys, in PyTorch, for the tests
that hold it to normalize_freqs.
"""

from __future__ import annotations

import numpy as np
import torch

from cpprcoder_tpu_torch.config import ANS_LOW, ANS_PROB_BITS, ANS_TOTAL, pick_lanes
from cpprcoder_tpu_torch.core.bytesutil import ByteReader, ByteWriter, as_u8
from cpprcoder_tpu_torch.models.static_table import exclusive_cumsum, normalize_freqs
from cpprcoder_tpu_torch.ops import layout
from cpprcoder_tpu_torch.ops.rc_common import i32_to_u32, u32_to_i32
from cpprcoder_tpu_torch.reference.ans2_ref import (
    ANS2_INC_DEFAULT,
    ANS2_LIMIT_LOG2_DEFAULT,
    _lane_desc,
    default_refresh_log2,
    snapshot_index,
)

MASK = ANS_TOTAL - 1
EMIT = 1 << 16        # event bit: the step emitted its low word
LIMIT_LOG2_NEVER = 63  # no total reaches 2^63: the rescale never fires


def check_params(inc: int, limit_log2: int, refresh_log2: int) -> None:
    """Raise ValueError unless each parameter fits its header byte."""
    for name, v in (("inc", inc), ("limit_log2", limit_log2),
                    ("refresh_log2", refresh_log2)):
        if not 0 <= v < 256:
            raise ValueError(f"{name}={v} does not fit the header's byte")


def refresh_eff(refresh_log2: int, steps: int) -> int:
    """The refresh_log2 that gives the same windows over `steps` steps and
    fits a u32 shift: at or past bitlen(steps - 1) every step lies below
    R, so every window is a warm-up window."""
    return min(refresh_log2, max(steps - 1, 0).bit_length())


def n_snapshots(steps: int, r: int) -> int:
    """Windows (tables) over `steps` >= 1 steps at refresh_log2 r."""
    return snapshot_index(steps - 1, 1 << r) + 1


def window_start(w: int, r: int) -> int:
    """First step of window w: 0, then 1, 2, 4, ..., R/2, then multiples
    of R."""
    if w == 0:
        return 0
    return 1 << (w - 1) if w <= r else (w - r) << r


def window_spans(n: int, k: int, r: int):
    """-> [(first, end) position of each window], end clipped to n."""
    steps = -(-n // k)
    ends = [min(window_start(w + 1, r), steps)
            for w in range(n_snapshots(steps, r))]
    return [(min(window_start(w, r) * k, n), min(e * k, n))
            for w, e in enumerate(ends)]


def _rescale(counts: np.ndarray, total: int, limit_log2: int):
    if total >= 1 << limit_log2:
        counts = (counts >> 1) | 1
        total = int(counts.sum())
    return counts, total


def _bitlen(x: torch.Tensor) -> torch.Tensor:
    """Bit lengths of int64 values in [0, 2^63)."""
    return (x[..., None] >= (1 << torch.arange(63, device=x.device))).sum(-1)


def normalize_sorted_plain(counts: torch.Tensor) -> torch.Tensor:
    """normalize_freqs(row, 14) of each row of counts [B, 256] int64 (each
    >= 0, each row's sum below 2^63) -> f int64 [B, 256], in the kernels'
    form (csrc/ans2_model.cuh warp_normalize): steps 1-3 as the spec; the
    d > 0 and d < 0 orders as a descending sort of packed unique keys, (r +
    1) << 8 | (255 - s) (absent: 255 - s) and f << 8 | (255 - s); d > 0: +1
    where a present key is at least the d-th largest; d < 0: the symbols
    above the sorted place where the excess (f - 1) before it reaches need
    drop to 1, that one gives the rest; rule 5 where one symbol is
    present."""
    b = counts.shape[0]
    dev = counts.device
    s = torch.arange(256, device=dev)
    low = 255 - s
    n = counts.sum(1, keepdim=True)
    shift = torch.clamp(_bitlen(torch.clamp(n - 1, min=0)) - ANS_PROB_BITS, min=0)
    present = counts > 0
    c = counts >> shift
    c = torch.where(present & (c == 0), 1, c)
    np_ = torch.clamp(c.sum(1, keepdim=True), min=1)
    f = (c << ANS_PROB_BITS) // np_
    r = (c << ANS_PROB_BITS) % np_
    f = torch.where(present & (f == 0), 1, f)
    d = ANS_TOTAL - f.sum(1, keepdim=True)
    rows = torch.arange(b, device=dev)[:, None]
    # d > 0: the d-th largest key
    kpos = (torch.where(present, r + 1, 0) << 8) | low
    spos = torch.sort(kpos, dim=1, descending=True).values
    t = spos[rows, torch.clamp(d - 1, 0, 255)]
    f = torch.where((d > 0) & present & (kpos >= t), f + 1, f)
    # d < 0: the sorted place where the excess before it reaches need
    kneg = (f << 8) | low
    sneg = torch.sort(kneg, dim=1, descending=True).values
    ex = torch.clamp((sneg >> 8) - 1, min=0)
    before = torch.cumsum(ex, 1) - ex
    need = -d
    here = (before < need) & (before + ex >= need)
    at = torch.argmax(here.to(torch.int64), 1, keepdim=True)
    bk = sneg.gather(1, at)
    bt = need - before.gather(1, at)
    neg = d < 0
    f = torch.where(neg & (kneg > bk), torch.clamp(f, max=1), f)
    f = torch.where(neg & (kneg == bk), f - bt, f)
    # rule 5: one present symbol holds all of 2^14
    one = present.sum(1, keepdim=True) == 1
    sym = torch.argmax(present.to(torch.int64), 1, keepdim=True)
    f = f - (one & (s == sym)).to(torch.int64) \
        + (one & (s == (sym + 1) % 256)).to(torch.int64)
    return torch.where(n > 0, f, 0)


def table_entries(freqs: torch.Tensor, cums: torch.Tensor) -> torch.Tensor:
    """(f, c) [B, 256] -> the entries X reads, int64 [B, 256]: rcp | (f | c
    << 16) << 32, rcp = floor((2^32 - 1) / f) (0 where f = 0), the bytes of
    kernel W's (rcp, f | c << 16) pairs."""
    f = freqs.to(torch.int64)
    rcp = torch.where(f > 0, 0xFFFFFFFF // torch.clamp(f, min=1), 0)
    return rcp | ((f | (cums.to(torch.int64) << 16)) << 32)


def entry_tables(entries: torch.Tensor):
    """Entries [B, 256] int64 -> (f, c) int64 [B, 256]."""
    return (entries >> 32) & 0xFFFF, (entries >> 48) & 0xFFFF


def normalize_tables_plain(counts: torch.Tensor) -> torch.Tensor:
    """Plain version of the normalize kernels W and Y share: counts [B,
    256] int64 -> the entries (`table_entries`) int64 [B, 256] of each
    row's normalize_freqs(row, 14), on the host."""
    f = np.stack([normalize_freqs(c, ANS_PROB_BITS)
                  for c in counts.cpu().numpy()]).reshape(-1, 256)
    cum = np.stack([exclusive_cumsum(row) for row in f]).reshape(-1, 256)
    return table_entries(*(torch.from_numpy(a.astype(np.int64))
                           for a in (f, cum))).to(counts.device)


def window_counts_plain(x2d: torch.Tensor, n: int, inc: int,
                        limit_log2: int, refresh_log2: int) -> torch.Tensor:
    """The model's counts at each window start, after its rescale, int64
    [n_snap, 256] on x2d's device: each window's histogram by
    `torch.bincount` over its positions, the walk over the windows on the
    host."""
    steps, k = x2d.shape
    r = refresh_eff(refresh_log2, steps)
    x = x2d.reshape(-1)
    spans = window_spans(n, k, r)
    hist = torch.stack([torch.bincount(x[a:b], minlength=256)
                        for a, b in spans]).cpu().numpy()
    counts = np.ones(256, dtype=np.int64)
    total = 256
    out = np.empty((len(spans), 256), dtype=np.int64)
    for w, (a, b) in enumerate(spans):
        counts, total = _rescale(counts, total, limit_log2)
        out[w] = counts
        counts = counts + hist[w] * inc
        total += (b - a) * inc
    return torch.from_numpy(out).to(x2d.device)


def window_tables_plain(x2d: torch.Tensor, n: int, inc: int,
                        limit_log2: int, refresh_log2: int):
    """Plain version of kernel W: x2d [steps, K] uint8 (interleaved, zero
    past n) -> entries int64 [n_snap, 256] (`table_entries`), window w's
    table in row w (the oracle's `_snapshots_and_counts`)."""
    return normalize_tables_plain(
        window_counts_plain(x2d, n, inc, limit_log2, refresh_log2))


# ------------------------------------------------------------------ encode

def encode_events_plain(x2d: torch.Tensor, lane_len: torch.Tensor,
                        entries: torch.Tensor, refresh_log2: int):
    """Plain version of kernel X: x2d [steps, K] uint8 -> (events [steps,
    K] int32, final states [K] int32), walking t = steps-1 .. 0, step t
    coding with table snapshot_index(t) of W's entries [n_snap, 256] (its
    (f, c); the divide is exact here)."""
    steps, k = x2d.shape
    r_steps = 1 << refresh_eff(refresh_log2, steps)
    f_t, c_t = entry_tables(entries)
    xs = x2d.to(torch.int64)
    lens = lane_len.to(torch.int64)
    st = torch.full((k,), ANS_LOW, dtype=torch.int64, device=x2d.device)
    events = torch.zeros((steps, k), dtype=torch.int64, device=x2d.device)
    for t in range(steps - 1, -1, -1):
        w = snapshot_index(t, r_steps)
        active = t < lens
        f = torch.where(active, f_t[w][xs[t]], 1)
        c = c_t[w][xs[t]]
        emit = active & ((st >> 18) >= f)     # wrap-free st >= f << 18
        events[t] = torch.where(active, torch.where(emit, EMIT, 0)
                                | (st & 0xFFFF), 0)
        st2 = torch.where(emit, st >> 16, st)
        q = st2 // f
        st = torch.where(active, (q << ANS_PROB_BITS) | (st2 - q * f + c), st)
    return u32_to_i32(events), u32_to_i32(st)


def stream_words(ev: torch.Tensor) -> torch.Tensor:
    """Events [steps, K] -> the emitted words in the decoder's read order
    (step-major, then lane-major), int32 [n_words]."""
    flat = ev.reshape(-1)
    return flat[(flat & EMIT) != 0] & 0xFFFF


def ans2_encode(data, lanes: int | None = None, inc: int = ANS2_INC_DEFAULT,
                limit_log2: int = ANS2_LIMIT_LOG2_DEFAULT,
                refresh_log2: int | None = None, *, device) -> bytes:
    """CT-ANS2 container of `data`, coded on `device` (kernels W and X on
    CUDA, their plain versions on the CPU). Same parameters as
    ans2_ref.ans2_encode."""
    x = as_u8(data)
    n = len(x)
    k = lanes or pick_lanes(n)
    r_log2 = (refresh_log2 if refresh_log2 is not None
              else default_refresh_log2(k, n))
    check_params(inc, limit_log2, r_log2)
    w = (ByteWriter().u32(n).u8(_lane_desc(k)).u8(inc).u8(limit_log2)
         .u8(r_log2))
    if n == 0:
        return w.getvalue()
    from cpprcoder_tpu_torch.ops import ans2_kernels

    steps = -(-n // k)
    xt = torch.from_numpy(x.copy()).to(device)
    x2d = layout.pad2d_interleaved(xt, k, steps)
    entries = ans2_kernels.window_tables(x2d, n, inc, limit_log2, r_log2)
    ev, states = ans2_kernels.encode_events(
        x2d, layout.lane_lengths_interleaved(n, k, steps, xt.device), entries,
        r_log2)
    words = stream_words(ev).cpu().numpy()
    w.u32s(i32_to_u32(states).cpu().numpy())
    w.u32(len(words))
    w.u16s(words)
    return w.getvalue()


# ------------------------------------------------------------------ decode

def decode_symbols_plain(words: torch.Tensor, states: torch.Tensor, n: int,
                         inc: int, limit_log2: int,
                         refresh_log2: int) -> torch.Tensor:
    """Plain version of kernel Y: the word stream [n_words] int16 (u16
    bits, the decoder's read order) and final states [K] int32 (u32 bits)
    -> uint8 [n] (byte t*K + j is lane j's step t). Words past the
    stream's end read as 0, as the oracle's."""
    k = states.numel()
    dev = states.device
    steps = -(-n // k)
    r = refresh_eff(refresh_log2, steps)
    nw = words.numel()
    w16 = words.to(torch.int64) & 0xFFFF
    lanes = torch.arange(k, device=dev)
    st = i32_to_u32(states)
    out = torch.zeros(steps * k, dtype=torch.uint8, device=dev)
    counts = np.ones(256, dtype=np.int64)
    total = 256
    hist = torch.zeros(256, dtype=torch.int64, device=dev)
    base = 0
    spans = iter(window_spans(n, k, r))
    start = 0
    for t in range(steps):
        if t * k == start:     # a window starts: the model of its table
            counts = counts + hist.cpu().numpy() * inc
            hist.zero_()
            counts, total = _rescale(counts, total, limit_log2)
            start, end = next(spans)
            total += (end - start) * inc
            start = end
            f_np = normalize_freqs(counts, ANS_PROB_BITS)
            f_t = torch.from_numpy(f_np.astype(np.int64)).to(dev)
            c_t = torch.from_numpy(exclusive_cumsum(f_np).astype(np.int64)).to(dev)
            cum2sym = torch.repeat_interleave(torch.arange(256, device=dev), f_t)
        nact = min(k, n - t * k)
        active = lanes < nact
        slot = st & MASK
        s = cum2sym[slot]
        st2 = f_t[s] * (st >> ANS_PROB_BITS) + slot - c_t[s]
        need = active & (st2 < ANS_LOW)
        idx = base + torch.cumsum(need.to(torch.int64), 0) - need.to(torch.int64)
        w = torch.where(idx < nw, w16[idx.clamp(max=max(nw - 1, 0))], 0) \
            if nw else torch.zeros_like(idx)
        st = torch.where(active, torch.where(need, (st2 << 16) | w, st2), st)
        base += int(need.sum())
        out[t * k:t * k + nact] = s[:nact].to(torch.uint8)
        hist += torch.bincount(s[:nact], minlength=256)
    return out[:n]


def ans2_decode(blob, *, device) -> bytes:
    r = ByteReader(blob)
    n = r.u32()
    k = 1 << r.u8()
    inc = r.u8()
    limit_log2 = r.u8()
    r_log2 = r.u8()
    if n == 0:
        return b""
    states = r.u32s(k)
    n_words = r.u32()
    words = r.u16s(n_words)
    from cpprcoder_tpu_torch.ops import ans2_kernels

    dev = torch.device(device)
    out = ans2_kernels.decode_symbols(
        torch.from_numpy(words.astype(np.uint16).view(np.int16)).to(dev),
        u32_to_i32(torch.from_numpy(states.astype(np.int64))).to(dev),
        n, inc, limit_log2, r_log2)
    return out.cpu().numpy().tobytes()
