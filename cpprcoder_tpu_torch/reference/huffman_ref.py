"""Oracle (host, exact) implementation of CT-HUF1 (FORMATS.md; the port's own
copy of cpprcoder_tpu/reference/huffman_ref.py).

Canonical length-limited Huffman, K round-robin lanes, per-lane LSB-first
bitstreams stored as u16-LE words. FORMAT (little-endian):

    [u32 rawSize n] [u8 lane_desc: log2(K)]
    [128 B code lengths, two 4-bit nibbles a byte, low nibble first]
    [K x u32 per-lane bit counts]
    [each lane's ceil(bits/16) u16 words, lane after lane]
"""

from __future__ import annotations

import numpy as np

from cpprcoder_tpu_torch.config import HUF_MAX_BITS, pick_lanes
from cpprcoder_tpu_torch.core.bytesutil import ByteReader, ByteWriter, as_u8
from cpprcoder_tpu_torch.models.huffman import build_decoder_lut, build_encoder_table


def _lane_desc(k: int) -> int:
    return k.bit_length() - 1


def pack_nibbles(lengths: np.ndarray) -> np.ndarray:
    l = np.asarray(lengths, dtype=np.uint8)
    return (l[0::2] | (l[1::2] << 4)).astype(np.uint8)


def unpack_nibbles(packed: np.ndarray) -> np.ndarray:
    p = np.asarray(packed, dtype=np.uint8)
    out = np.zeros(256, dtype=np.uint8)
    out[0::2] = p & 0xF
    out[1::2] = p >> 4
    return out


def huffman_encode(data, lanes: int | None = None) -> bytes:
    x = as_u8(data)
    n = len(x)
    k = lanes or pick_lanes(n)
    w = ByteWriter().u32(n)
    if n == 0:
        return w.u8(_lane_desc(k)).getvalue()
    counts = np.bincount(x, minlength=256)
    lengths, codes = build_encoder_table(counts)
    accs = [0] * k
    nbits = [0] * k
    streams: list[list[int]] = [[] for _ in range(k)]
    bitcounts = [0] * k
    for i in range(n):
        j = i % k
        s = int(x[i])
        l = int(lengths[s])
        accs[j] |= int(codes[s]) << nbits[j]
        nbits[j] += l
        bitcounts[j] += l
        if nbits[j] >= 16:
            streams[j].append(accs[j] & 0xFFFF)
            accs[j] >>= 16
            nbits[j] -= 16
    for j in range(k):
        if nbits[j] > 0:
            streams[j].append(accs[j] & 0xFFFF)
    w.u8(_lane_desc(k))
    w.raw(pack_nibbles(lengths).tobytes())
    w.u32s(bitcounts)
    for j in range(k):
        w.u16s(streams[j])
    return w.getvalue()


def huffman_decode(blob) -> bytes:
    r = ByteReader(blob)
    n = r.u32()
    k = 1 << r.u8()
    if n == 0:
        return b""
    lengths = unpack_nibbles(r.raw(128))
    bitcounts = r.u32s(k).astype(np.int64)
    word_counts = (bitcounts + 15) // 16
    words = r.u16s(int(word_counts.sum()))
    bases = np.concatenate(([0], np.cumsum(word_counts)))[:-1]
    lut = build_decoder_lut(lengths, HUF_MAX_BITS)
    out = bytearray(n)
    curs = [0] * k
    for i in range(n):
        j = i % k
        cur = curs[j]
        wi = int(bases[j]) + (cur >> 4)
        w0 = int(words[wi]) if wi < len(words) else 0
        w1 = int(words[wi + 1]) if wi + 1 < len(words) else 0
        window = ((w0 | (w1 << 16)) >> (cur & 15)) & ((1 << HUF_MAX_BITS) - 1)
        v = int(lut[window])
        out[i] = v & 0xFF
        curs[j] = cur + (v >> 8)
    return bytes(out)
