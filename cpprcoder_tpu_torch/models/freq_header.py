"""Packed frequency-table headers for CT-ANS1 (FORMATS.md; the port's own
copy of cpprcoder_tpu/models/freq_header.py).

A table of 256 frequencies is packed as:

  128 B nibble classes   b[s] = min(bitlength(f), 15), 0 if f == 0;
                         symbol s in byte s//2, LOW nibble first
  extra-bit stream       per symbol, LSB-first packed:
                         b <= 1: nothing (f = b)
                         2 <= b < 15: b-1 bits holding f - 2^(b-1)
                         b == 15: 16 bits holding f - 2^14

Self-delimiting given the nibbles (the decoder derives the extra-bit
count), so no length prefix.
"""

from __future__ import annotations

import numpy as np

NIBBLE_BYTES = 128
_ESC = 15
_ESC_BASE = 1 << 14
_ESC_BITS = 16


def _extra_bits(b: np.ndarray) -> np.ndarray:
    return np.where(b <= 1, 0, np.where(b < _ESC, b - 1, _ESC_BITS))


def pack_freqs(freqs) -> bytes:
    f = np.asarray(freqs, dtype=np.int64)
    if f.shape != (256,):
        raise ValueError("freq table must have 256 entries")
    bl = np.where(f > 0, np.floor(np.log2(np.maximum(f, 1))).astype(np.int64) + 1, 0)
    b = np.minimum(bl, _ESC)
    nib = (b[0::2] | (b[1::2] << 4)).astype(np.uint8)
    eb = _extra_bits(b)
    val = np.where(b < _ESC, f - (1 << np.maximum(b, 1) >> 1), f - _ESC_BASE)
    out = bytearray(nib.tobytes())
    acc = 0
    nbits = 0
    for s in range(256):
        if eb[s]:
            acc |= int(val[s]) << nbits
            nbits += int(eb[s])
            while nbits >= 8:
                out.append(acc & 0xFF)
                acc >>= 8
                nbits -= 8
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def packed_size(first_128_bytes: np.ndarray | bytes) -> int:
    """Total header byte count, from the nibble section alone."""
    nib = np.frombuffer(bytes(first_128_bytes), np.uint8)
    b = np.stack([nib & 0xF, nib >> 4], axis=1).reshape(-1).astype(np.int64)
    return NIBBLE_BYTES + (int(_extra_bits(b).sum()) + 7) // 8


def unpack_freqs(buf: bytes | np.ndarray, expected_total: int | None = None
                 ) -> np.ndarray:
    """buf starts at the header; reads exactly packed_size() bytes."""
    buf = bytes(buf[:NIBBLE_BYTES]) + bytes(
        buf[NIBBLE_BYTES:NIBBLE_BYTES + 512 + 2])
    nib = np.frombuffer(buf[:NIBBLE_BYTES], np.uint8)
    b = np.stack([nib & 0xF, nib >> 4], axis=1).reshape(-1).astype(np.int64)
    eb = _extra_bits(b)
    f = np.where(b <= 1, b, 0).astype(np.int64)
    acc = 0
    nbits = 0
    pos = NIBBLE_BYTES
    for s in range(256):
        w = int(eb[s])
        if not w:
            continue
        while nbits < w:
            acc |= buf[pos] << nbits
            pos += 1
            nbits += 8
        v = acc & ((1 << w) - 1)
        acc >>= w
        nbits -= w
        f[s] = (_ESC_BASE if b[s] == _ESC else (1 << (b[s] - 1))) + v
    if expected_total is not None and int(f.sum()) != expected_total:
        raise ValueError(
            f"freq header sums to {int(f.sum())}, expected {expected_total}")
    return f


def read_freqs(r, expected_total: int | None = None) -> np.ndarray:
    """Consume one packed table from a bytesutil.ByteReader."""
    size = packed_size(r.buf[r.pos:r.pos + NIBBLE_BYTES])
    return unpack_freqs(r.raw(size), expected_total)
