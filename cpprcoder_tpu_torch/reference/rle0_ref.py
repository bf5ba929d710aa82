"""Oracle (host, exact) implementation of CT-RLE0 (FORMATS.md).

Zero-run-length transform for BWT+MTF output (the bzip2-style ZRLE stage;
the reference library has no equivalent — its BWT pipeline feeds zlib/zstd
directly, test/main.cpp:968-987 — this stage is part of why our Config-4
pipeline beats those numbers). Byte-level bijective base-2 run coding:

  - a run of L >= 1 zeros is coded as m = floor(log2(L+1)) digit bytes,
    digit j = ((L+1) >> j) & 1, least-significant first (each digit byte
    is 0 or 1). Equivalently L = sum_j (1 + d_j) * 2^j  (RUNA/RUNB).
  - a nonzero byte r in 1..253 is coded as the single byte r+1 (2..254).
  - r in {254, 255} is coded as the pair (255, r-254). Byte 255 therefore
    only ever appears as an escape marker and its payload is always 0 or 1.

Container: u32 raw_size, then the token bytes.

(The port's own copy of cpprcoder_tpu/reference/rle0_ref.py, whole.)
"""

from __future__ import annotations

import numpy as np

from cpprcoder_tpu_torch.core.bytesutil import ByteReader, ByteWriter, as_u8


def rle0_encode(data) -> bytes:
    x = as_u8(data)
    n = len(x)
    w = ByteWriter().u32(n)
    out = bytearray()
    i = 0
    while i < n:
        b = int(x[i])
        if b == 0:
            j = i
            while j < n and x[j] == 0:
                j += 1
            m = (j - i) + 1  # L + 1
            while m > 1:
                out.append(m & 1)
                m >>= 1
            i = j
        elif b <= 253:
            out.append(b + 1)
            i += 1
        else:
            out.append(255)
            out.append(b - 254)
            i += 1
    w.raw(bytes(out))
    return w.getvalue()


def rle0_decode(blob) -> bytes:
    r = ByteReader(blob)
    n = r.u32()
    y = r.rest()
    out = np.zeros(n, np.uint8)
    pos = 0
    i = 0
    t = len(y)
    while i < t:
        b = int(y[i])
        if b <= 1:
            run = 0
            shift = 0
            while i < t and int(y[i]) <= 1:
                run += (1 + int(y[i])) << shift
                shift += 1
                i += 1
            pos += run  # zeros are already in place
        elif b <= 254:
            out[pos] = b - 1
            pos += 1
            i += 1
        else:
            out[pos] = 254 + int(y[i + 1])
            pos += 1
            i += 2
    if pos != n:
        raise ValueError(f"CT-RLE0: decoded {pos} bytes, expected {n}")
    return out.tobytes()
