"""Oracle (host, exact) implementation of CT-ANS1 v2 (FORMATS.md; the port's
own copy of cpprcoder_tpu/reference/rans_ref.py).

K-lane interleaved rANS with PER-LANE u16-word streams. ProbBits = 14,
state lower bound 2^16, u16-word renormalization with at most one word per
symbol in either direction. Encoding walks the input backwards; each
lane's emitted words, reversed, are exactly that lane's forward read
order.
"""

from __future__ import annotations

import numpy as np

from cpprcoder_tpu_torch.config import ANS_LOW, ANS_PROB_BITS, ANS_TOTAL, pick_lanes
from cpprcoder_tpu_torch.core.bytesutil import (
    ByteReader,
    ByteWriter,
    CorruptContainerError,
    as_u8,
)
from cpprcoder_tpu_torch.models.freq_header import pack_freqs, read_freqs
from cpprcoder_tpu_torch.models.static_table import exclusive_cumsum, normalize_freqs

MASK = ANS_TOTAL - 1


def _lane_desc(k: int, wide: bool = False) -> int:
    return (k.bit_length() - 1) | (0x80 if wide else 0)


def _parse_lane_desc(b: int) -> tuple[int, bool]:
    log2k = b & 0x1F
    if log2k > 16:
        raise CorruptContainerError(f"absurd lane count 2^{log2k}")
    return 1 << log2k, bool(b & 0x80)


def rans_encode(data, lanes: int | None = None) -> bytes:
    x = as_u8(data)
    n = len(x)
    k = lanes or pick_lanes(n)
    w = ByteWriter().u32(n)
    if n == 0:
        return w.u8(_lane_desc(k)).getvalue()
    counts = np.bincount(x, minlength=256)
    freqs = normalize_freqs(counts, ANS_PROB_BITS)
    cums = exclusive_cumsum(freqs)
    states = [ANS_LOW] * k
    emitted: list[list[int]] = [[] for _ in range(k)]
    for i in range(n - 1, -1, -1):
        j = i % k
        s = int(x[i])
        f = int(freqs[s])
        c = int(cums[s])
        st = states[j]
        if (st >> 18) >= f:          # renorm: emit low 16 bits
            emitted[j].append(st & 0xFFFF)
            st >>= 16
        states[j] = ((st // f) << ANS_PROB_BITS) | ((st % f) + c)
    lane_words = [lane[::-1] for lane in emitted]   # per-lane read order
    wide = max(len(lw) for lw in lane_words) > 0xFFFF
    w.u8(_lane_desc(k, wide)).raw(pack_freqs(freqs))
    w.u32s(states)
    cnts = [len(lw) for lw in lane_words]
    w.u32s(cnts) if wide else w.u16s(cnts)
    for lw in lane_words:
        w.u16s(lw)
    return w.getvalue()


def rans_decode(blob) -> bytes:
    r = ByteReader(blob)
    n = r.u32()
    k, wide = _parse_lane_desc(r.u8())
    if n == 0:
        return b""
    freqs = read_freqs(r, ANS_TOTAL)
    cums = exclusive_cumsum(freqs)
    states = [int(v) for v in r.u32s(k)]
    cnts = (r.u32s(k) if wide else r.u16s(k)).astype(np.int64)
    lane_words = [r.u16s(int(c)) for c in cnts]
    cum2sym = np.repeat(np.arange(256, dtype=np.uint8), freqs)
    out = bytearray(n)
    pos = [0] * k
    for i in range(n):
        j = i % k
        st = states[j]
        slot = st & MASK
        s = int(cum2sym[slot])
        out[i] = s
        st = int(freqs[s]) * (st >> ANS_PROB_BITS) + slot - int(cums[s])
        if st < ANS_LOW:
            word = int(lane_words[j][pos[j]]) if pos[j] < cnts[j] else 0
            pos[j] += 1
            st = (st << 16) | word
        states[j] = st
    return bytes(out)
