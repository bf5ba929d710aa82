"""Oracle (host, exact) implementation of CT-BWT1 (FORMATS.md).

Cyclic-rotation Burrows-Wheeler transform over independent blocks — the
reference's BlkSort (blksort.h:76-108,401-661) semantics: rotations (not
suffixes) are sorted; output per block = last column + row index of the
original string; trailing partial block stored raw. Sorting here is
prefix-doubling with np.lexsort (the multikey quicksort of blksort.h:276-350
is replaced, not translated).

(The port's own copy of cpprcoder_tpu/reference/bwt_ref.py, whole.)
"""

from __future__ import annotations

import numpy as np

from cpprcoder_tpu_torch.core.bytesutil import ByteReader, ByteWriter, as_u8

MIN_TAIL_LOG2 = 8  # smallest tail sub-block (256 B); below this: raw


def block_layout(n: int, block_log2: int) -> tuple[list[int], int]:
    """CT-BWT1 block layout: n//2^block_log2 full blocks, then the tail is
    binary-decomposed into power-of-two sub-blocks down to 2^MIN_TAIL_LOG2
    (so files smaller than one block still get transformed — unlike the
    reference, which stores any partial block raw, blksort.h:435-441).
    Returns (block sizes in stream order, raw remainder byte count)."""
    bs = 1 << block_log2
    nb = n // bs
    t = n - nb * bs
    sizes = [bs] * nb
    for j in range(block_log2 - 1, MIN_TAIL_LOG2 - 1, -1):
        if t & (1 << j):
            sizes.append(1 << j)
            t -= 1 << j
    return sizes, t


def bwt_forward_block(block: np.ndarray) -> tuple[np.ndarray, int]:
    """Return (last_column, row_index) for one block (cyclic rotations)."""
    b = len(block)
    rank = block.astype(np.int64)
    idx = np.arange(b)
    h = 1
    while h < b:
        key2 = np.roll(rank, -h)
        order = np.lexsort((idx, key2, rank))  # stable; idx tiebreak
        r1 = rank[order]
        r2 = key2[order]
        diff = np.empty(b, dtype=np.int64)
        diff[0] = 0
        diff[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        new_sorted = np.cumsum(diff)
        rank = np.empty(b, dtype=np.int64)
        rank[order] = new_sorted
        if rank.max() == b - 1:
            break
        h <<= 1
    order = np.lexsort((np.arange(b), rank))
    last = block[(order - 1) % b]
    row = int(np.nonzero(order == 0)[0][0])
    return last, row


def bwt_inverse_block(last: np.ndarray, row: int) -> np.ndarray:
    """Invert one block: stable sort of the last column gives the next-map."""
    b = len(last)
    t = np.argsort(last, kind="stable")
    out = np.empty(b, dtype=np.uint8)
    p = row
    for i in range(b):
        p = t[p]
        out[i] = last[p]
    return out


def bwt_encode(data, block_log2: int = 15) -> bytes:
    x = as_u8(data)
    n = len(x)
    w = ByteWriter().u32(n).u8(block_log2)
    sizes, rem = block_layout(n, block_log2)
    off = 0
    for bs in sizes:
        last, row = bwt_forward_block(x[off:off + bs])
        w.raw(last.tobytes()).u32(row)
        off += bs
    w.raw(x[n - rem:].tobytes())
    return w.getvalue()


def bwt_decode(blob) -> bytes:
    r = ByteReader(blob)
    n = r.u32()
    sizes, rem = block_layout(n, r.u8())
    out = bytearray()
    for bs in sizes:
        last = r.raw(bs)
        row = r.u32()
        out += bwt_inverse_block(last, row).tobytes()
    out += r.raw(rem).tobytes()
    return bytes(out)
