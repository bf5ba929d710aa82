"""Quantized windowed adaptive model of CT-RCQ: constants, the parameter
policy and the numpy model the oracle codes with (the port's own copy of
the numpy part of cpprcoder_tpu/models/qmodel.py).

Adaptive COUNTS C[256] (incremented per K-symbol window, halved at a
threshold) code against a quantized table Q[256] with Sum(Q) = 2^QBITS
exactly, re-derived from C at every window boundary:

    t = range >> QBITS          (encoder and decoder)
    decode search compares cum[s]*t <= code   (u32-exact products)

Invariants (enforced by rcq_params):
  - rescale: while tot >= climit: C = (C >> 1) | 1   (single halving
    suffices when K*inc < climit: tot < climit + K*inc <= 2*climit)
  - u32 exactness: max C * (T - 256) < 2^32 requires
    climit + K*inc <= 132,000; params keep climit = 2^16, K*inc <= 49,152.
"""

from __future__ import annotations

import numpy as np

QBITS = 15
QTOTAL = 1 << QBITS
QRESERVE = 256          # one slot per symbol stays reserved (decodability)
CLIMIT_LOG2 = 16
INC_DEFAULT = 24
MAX_K_TIMES_INC = 49152


def rcq_params(n: int, lanes: int | None = None,
               inc: int | None = None) -> tuple[int, int, int]:
    """(k, inc, climit_log2) for an n-byte input.

    The lane count trades the shared-model window size (= K symbols; smaller
    windows adapt faster) against parallel width; the default keeps windows
    modest."""
    if lanes is None:
        k = 32
        while k * 2 <= max(1, n // 256) and k < 2048:
            k *= 2
    else:
        k = lanes
    if inc is None:
        inc = min(INC_DEFAULT, max(1, MAX_K_TIMES_INC // k))
    assert k * inc <= MAX_K_TIMES_INC, "u32 exactness bound (module doc)"
    return k, inc, CLIMIT_LOG2


def quantize_np(C: np.ndarray) -> np.ndarray:
    """C [256] u32 counts -> Q [256] with Sum(Q) == QTOTAL, every Q >= 1.

    Deterministic: floor division against (QTOTAL - QRESERVE), remainder to
    the first-argmax entry. u32-exact by the invariants above."""
    C = C.astype(np.uint64)
    tot = C.sum()
    q = np.maximum((C * (QTOTAL - QRESERVE)) // tot, 1).astype(np.uint32)
    rem = QTOTAL - int(q.sum())
    q[int(np.argmax(q))] += rem
    return q


def rescale_np(C: np.ndarray, climit: int) -> np.ndarray:
    """Single conditional halving. Sufficient: tot < climit + K*inc and
    K*inc <= climit - 256 imply the halved total (tot/2 + 128) is back
    below climit."""
    if int(C.sum()) >= climit:
        C = (C >> 1) | 1
    assert int(C.sum()) < climit
    return C


def update_np(C: np.ndarray, syms: np.ndarray, inc: int) -> np.ndarray:
    return C + np.bincount(syms, minlength=256).astype(np.uint32) * np.uint32(inc)
