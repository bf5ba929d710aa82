"""Oracle (host, exact) implementation of CT-ASE1 (FORMATS.md; the port's own
copy of cpprcoder_tpu/reference/ase_ref.py).

Adaptive-symbol-encoder (reference parity: cppase.h:71-324): per lane a
64-entry recency list; a hit at distance d from the back emits (d<<1)|1 in
entropy(size)+1 bits; a miss emits (byte<<1) in 9 bits and evicts the front
when full; bits are LSB-first. CT-ASE1 runs K round-robin lanes, each with
its own list, storing per-lane streams as u16-LE words (like CT-HUF1).
"""

from __future__ import annotations

import numpy as np

from cpprcoder_tpu_torch.config import pick_lanes
from cpprcoder_tpu_torch.core.bytesutil import ByteReader, ByteWriter, as_u8

TABLE_SIZE = 64

ENTROPY = np.zeros(TABLE_SIZE + 1, np.int64)
for _s in range(TABLE_SIZE + 1):
    e = 0
    while (1 << e) < _s:
        e += 1
    ENTROPY[_s] = e


def _lane_desc(k: int) -> int:
    return k.bit_length() - 1


class _Lane:
    def __init__(self):
        self.table: list[int] = []
        self.bits = 0
        self.acc = 0
        self.nbits = 0
        self.words: list[int] = []
        self.bitcount = 0

    def put(self, value: int, width: int):
        self.acc |= value << self.nbits
        self.nbits += width
        self.bitcount += width
        if self.nbits >= 16:
            self.words.append(self.acc & 0xFFFF)
            self.acc >>= 16
            self.nbits -= 16

    def encode_symbol(self, sym: int):
        t = self.table
        if sym in t:
            idx = t.index(sym)
            out = len(t) - 1 - idx
            del t[idx]
            t.append(sym)
            self.put((out << 1) | 1, self.bits + 1)
        else:
            if len(t) >= TABLE_SIZE:
                del t[0]
                t.append(sym)
            else:
                t.append(sym)
                self.bits = int(ENTROPY[len(t)])
            self.put(sym << 1, 9)

    def flush(self):
        if self.nbits > 0:
            self.words.append(self.acc & 0xFFFF)


def ase_encode(data, lanes: int | None = None) -> bytes:
    x = as_u8(data)
    n = len(x)
    k = lanes or pick_lanes(n)
    w = ByteWriter().u32(n).u8(_lane_desc(k))
    if n == 0:
        return w.getvalue()
    ls = [_Lane() for _ in range(k)]
    for i in range(n):
        ls[i % k].encode_symbol(int(x[i]))
    for lane in ls:
        lane.flush()
    w.u32s([lane.bitcount for lane in ls])
    for lane in ls:
        w.u16s(lane.words)
    return w.getvalue()


def ase_decode(blob) -> bytes:
    r = ByteReader(blob)
    n = r.u32()
    k = 1 << r.u8()
    if n == 0:
        return b""
    bitcounts = r.u32s(k).astype(np.int64)
    word_counts = (bitcounts + 15) // 16
    words = r.u16s(int(word_counts.sum()))
    bases = np.concatenate(([0], np.cumsum(word_counts)))[:-1]
    tables: list[list[int]] = [[] for _ in range(k)]
    bits = [0] * k
    curs = [0] * k
    out = bytearray(n)
    for i in range(n):
        j = i % k
        cur = curs[j]
        wi = int(bases[j]) + (cur >> 4)
        w0 = int(words[wi]) if wi < len(words) else 0
        w1 = int(words[wi + 1]) if wi + 1 < len(words) else 0
        window = (w0 | (w1 << 16)) >> (cur & 15)
        t = tables[j]
        if window & 1:
            d = (window >> 1) & ((1 << bits[j]) - 1)
            curs[j] = cur + 1 + bits[j]
            idx = len(t) - 1 - d
            sym = t[idx]
            del t[idx]
            t.append(sym)
        else:
            sym = (window >> 1) & 0xFF
            curs[j] = cur + 9
            if len(t) >= TABLE_SIZE:
                del t[0]
                t.append(sym)
            else:
                t.append(sym)
                bits[j] = int(ENTROPY[len(t)])
        out[i] = sym
    return bytes(out)
