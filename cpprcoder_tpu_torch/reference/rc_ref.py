"""Oracle (host, exact) CT-RC1 / CT-RC2, and the scalar range-coder lane and
the lane-descriptor and size-table helpers that the port's CT-RCX and
CT-RCQ oracles share (its own copy of cpprcoder_tpu/reference/rc_ref.py;
the CT-RC1/CT-RC2 functions are its lines 118-244, as they are there).

LZMA-style carry-delayed range coder: 32-bit low/range, renormalization at
2^24, carry through a cache byte plus a 0xFF run; flush rounds low up to a
multiple of 2^24 and shifts twice (FORMATS.md "Shared range-coder core").
"""

from __future__ import annotations

import numpy as np

from cpprcoder_tpu_torch.config import (
    MASK32,
    RC_TOP,
    STATIC_TOTAL,
    STATIC_TOTAL_BITS,
    adaptive_params_for,
    pick_lanes,
)
from cpprcoder_tpu_torch.core.bytesutil import (
    ByteReader,
    ByteWriter,
    CorruptContainerError,
    as_u8,
)
from cpprcoder_tpu_torch.models.freq_header import pack_freqs, read_freqs
from cpprcoder_tpu_torch.models.static_table import exclusive_cumsum, normalize_freqs


class LaneEncoder:
    """One range-coder lane (see FORMATS.md 'Shared range-coder core')."""

    def __init__(self):
        self.low = 0              # python int; bit 32 is the pending carry
        self.range = MASK32
        self.cache = 0
        self.cache_size = 1       # includes the initial dummy byte
        self.out = bytearray()

    def _shift_low(self):
        low32 = self.low & MASK32
        if low32 < 0xFF000000 or self.low > MASK32:
            carry = self.low >> 32
            self.out.append((self.cache + carry) & 0xFF)
            if self.cache_size > 1:
                self.out.extend(((0xFF + carry) & 0xFF,) * (self.cache_size - 1))
            self.cache = (low32 >> 24) & 0xFF
            self.cache_size = 0
        self.cache_size += 1
        self.low = (low32 << 8) & MASK32

    def encode(self, cum: int, freq: int, total: int, t: int):
        self.low += t * cum
        if cum + freq == total:
            self.range -= t * cum
        else:
            self.range = t * freq
        while self.range < RC_TOP:
            self._shift_low()
            self.range = (self.range << 8) & MASK32

    def finish(self) -> bytes:
        # round the code value up to a multiple of 2^24 (valid: range >= 2^24)
        self.low += (-self.low) & 0xFFFFFF
        self._shift_low()
        self._shift_low()
        return bytes(self.out[1:])  # drop the initial dummy byte


class LaneDecoder:
    def __init__(self, payload: np.ndarray):
        self.data = payload
        self.pos = 0
        self.range = MASK32
        code = 0
        for _ in range(4):
            code = (code << 8) | self._next_byte()
        self.code = code

    def _next_byte(self) -> int:
        b = int(self.data[self.pos]) if self.pos < len(self.data) else 0
        self.pos += 1
        return b

    def decode_target(self, total: int, t: int) -> int:
        return min(self.code // t, total - 1)

    def consume(self, cum: int, freq: int, total: int, t: int):
        self.code -= t * cum
        if cum + freq == total:
            self.range -= t * cum
        else:
            self.range = t * freq
        while self.range < RC_TOP:
            self.code = ((self.code << 8) | self._next_byte()) & MASK32
            self.range = (self.range << 8) & MASK32


def _lane_desc(k: int, wide_sizes: bool) -> int:
    return (k.bit_length() - 1) | (0x80 if wide_sizes else 0)


def _parse_lane_desc(b: int) -> tuple[int, bool]:
    log2k = b & 0x1F
    if log2k > 16:
        raise CorruptContainerError(f"absurd lane count 2^{log2k}")
    return 1 << log2k, bool(b & 0x80)


def _write_sizes(w: ByteWriter, sizes: list[int], wide: bool):
    if wide:
        w.u32s(sizes)
    else:
        w.u16s(sizes)


# ---------------------------------------------------------------- CT-RC1

def static_encode(data, lanes: int | None = None) -> bytes:
    x = as_u8(data)
    n = len(x)
    k = lanes or pick_lanes(n)
    w = ByteWriter().u32(n)
    if n == 0:
        return w.u8(_lane_desc(k, False)).getvalue()
    counts = np.bincount(x, minlength=256)
    freqs = normalize_freqs(counts, STATIC_TOTAL_BITS)
    cums = exclusive_cumsum(freqs)
    encs = [LaneEncoder() for _ in range(k)]
    for i in range(n):
        e = encs[i % k]
        s = int(x[i])
        e.encode(int(cums[s]), int(freqs[s]), STATIC_TOTAL, e.range >> STATIC_TOTAL_BITS)
    payloads = [e.finish() for e in encs]
    sizes = [len(p) for p in payloads]
    wide = max(sizes) >= 1 << 16
    w.u8(_lane_desc(k, wide)).raw(pack_freqs(freqs))
    _write_sizes(w, sizes, wide)
    for p in payloads:
        w.raw(p)
    return w.getvalue()


def static_decode(blob) -> bytes:
    r = ByteReader(blob)
    n = r.u32()
    k, wide = _parse_lane_desc(r.u8())
    if n == 0:
        return b""
    freqs = read_freqs(r, STATIC_TOTAL)
    cums = exclusive_cumsum(freqs)
    sizes = (r.u32s(k) if wide else r.u16s(k)).astype(np.int64)
    payload = r.rest()
    offsets = np.concatenate(([0], np.cumsum(sizes)))
    decs = [LaneDecoder(payload[offsets[j]:offsets[j + 1]]) for j in range(k)]
    out = bytearray(n)
    # symbol lookup table: 2^16 → symbol (static total is small enough)
    sym_of = np.repeat(np.arange(256, dtype=np.uint8), freqs)
    for i in range(n):
        d = decs[i % k]
        t = d.range >> STATIC_TOTAL_BITS
        v = d.decode_target(STATIC_TOTAL, t)
        s = int(sym_of[v])
        out[i] = s
        d.consume(int(cums[s]), int(freqs[s]), STATIC_TOTAL, t)
    return bytes(out)


# ---------------------------------------------------------------- CT-RC2

def adaptive_encode(data, lanes: int | None = None, inc: int | None = None,
                    limit_log2: int | None = None) -> bytes:
    x = as_u8(data)
    n = len(x)
    k = lanes or pick_lanes(n)
    inc0, limit0 = adaptive_params_for(k)
    inc = inc if inc is not None else inc0
    limit_log2 = limit_log2 if limit_log2 is not None else limit0
    limit = 1 << limit_log2
    w = ByteWriter().u32(n)
    if n == 0:
        return w.u8(_lane_desc(k, False)).u8(inc).u8(limit_log2).getvalue()
    freqs = np.ones(256, dtype=np.int64)
    total = 256
    encs = [LaneEncoder() for _ in range(k)]
    steps = (n + k - 1) // k
    for tstep in range(steps):
        if total >= limit:
            freqs = (freqs >> 1) | 1
            total = int(freqs.sum())
        cums = np.concatenate(([0], np.cumsum(freqs[:-1])))
        base = tstep * k
        active = min(k, n - base)
        for j in range(active):
            e = encs[j]
            s = int(x[base + j])
            e.encode(int(cums[s]), int(freqs[s]), total, e.range // total)
        hist = np.bincount(x[base:base + active], minlength=256)
        freqs = freqs + hist.astype(np.int64) * inc
        total += active * inc
    payloads = [e.finish() for e in encs]
    sizes = [len(p) for p in payloads]
    wide = max(sizes) >= 1 << 16
    w.u8(_lane_desc(k, wide)).u8(inc).u8(limit_log2)
    _write_sizes(w, sizes, wide)
    for p in payloads:
        w.raw(p)
    return w.getvalue()


def adaptive_decode(blob) -> bytes:
    r = ByteReader(blob)
    n = r.u32()
    k, wide = _parse_lane_desc(r.u8())
    inc = r.u8()
    limit = 1 << r.u8()
    if n == 0:
        return b""
    sizes = (r.u32s(k) if wide else r.u16s(k)).astype(np.int64)
    payload = r.rest()
    offsets = np.concatenate(([0], np.cumsum(sizes)))
    decs = [LaneDecoder(payload[offsets[j]:offsets[j + 1]]) for j in range(k)]
    out = bytearray(n)
    freqs = np.ones(256, dtype=np.int64)
    total = 256
    steps = (n + k - 1) // k
    for tstep in range(steps):
        if total >= limit:
            freqs = (freqs >> 1) | 1
            total = int(freqs.sum())
        cums = np.concatenate(([0], np.cumsum(freqs[:-1])))
        base = tstep * k
        active = min(k, n - base)
        for j in range(active):
            d = decs[j]
            t = d.range // total
            v = d.decode_target(total, t)
            s = int(np.searchsorted(cums, v, side="right")) - 1
            out[base + j] = s
            d.consume(int(cums[s]), int(freqs[s]), total, t)
        hist = np.bincount(np.frombuffer(out, dtype=np.uint8, count=active, offset=base),
                           minlength=256)
        freqs = freqs + hist.astype(np.int64) * inc
        total += active * inc
    return bytes(out)
