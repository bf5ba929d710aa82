"""Oracle (host, exact) implementation of CT-MTF1 (FORMATS.md).

Move-to-front byte transform over independent 2^15-byte blocks (parallel
units), initial list = identity. Variant `mtf1` mirrors the reference's
MTF-1 exactly (blksort.h:740-753,776-787): ranks > 1 move the symbol to
position 1 (mtf_move_to_front_one, blksort.h:718-724); a rank-1 hit swaps
to position 0 only when the previously emitted rank was nonzero; prev is
initialized to 1.

(The port's own copy of cpprcoder_tpu/reference/mtf_ref.py, whole.)
"""

from __future__ import annotations

import numpy as np

from cpprcoder_tpu_torch.core.bytesutil import ByteReader, ByteWriter, as_u8

MTF_BLOCK = 1 << 15


def _mtf1_update(lst, r, prev):
    if r == 1:
        if prev != 0:
            lst[0], lst[1] = lst[1], lst[0]
    elif r > 1:
        lst.insert(1, lst.pop(r))


def mtf_encode_block(block: np.ndarray, mtf1: bool) -> np.ndarray:
    lst = list(range(256))
    out = np.empty(len(block), dtype=np.uint8)
    prev = 1
    for i, b in enumerate(block):
        b = int(b)
        r = lst.index(b)
        out[i] = r
        if mtf1:
            _mtf1_update(lst, r, prev)
        elif r > 0:
            lst.insert(0, lst.pop(r))
        prev = r
    return out


def mtf_decode_block(ranks: np.ndarray, mtf1: bool) -> np.ndarray:
    lst = list(range(256))
    out = np.empty(len(ranks), dtype=np.uint8)
    prev = 1
    for i, r in enumerate(ranks):
        r = int(r)
        b = lst[r]
        out[i] = b
        if mtf1:
            _mtf1_update(lst, r, prev)
        elif r > 0:
            lst.insert(0, lst.pop(r))
        prev = r
    return out


def mtf_encode(data, mtf1: bool = False) -> bytes:
    x = as_u8(data)
    n = len(x)
    w = ByteWriter().u32(n).u8(1 if mtf1 else 0)
    for i in range(0, n, MTF_BLOCK):
        w.raw(mtf_encode_block(x[i:i + MTF_BLOCK], mtf1).tobytes())
    return w.getvalue()


def mtf_decode(blob) -> bytes:
    r = ByteReader(blob)
    n = r.u32()
    mtf1 = bool(r.u8())
    out = bytearray()
    for i in range(0, n, MTF_BLOCK):
        ranks = r.raw(min(MTF_BLOCK, n - i))
        out += mtf_decode_block(ranks, mtf1).tobytes()
    return bytes(out)
