"""Coder constants and the lane policy of the port (its own copy of the
parts of cpprcoder_tpu/config.py it uses; the two must agree, which
tests/test_torch_host_copies.py checks).

The lane count K is a first-class knob: small inputs use few lanes (keeping
per-lane overhead negligible for compression ratio), large inputs scale to
thousands of lanes.
"""

from __future__ import annotations

# ---- range coder core constants ----
RC_TOP = 1 << 24          # renormalization threshold
MASK32 = 0xFFFFFFFF
STATIC_TOTAL_BITS = 16    # CT-RC1 static table total = 2^16 (division-free t)
STATIC_TOTAL = 1 << STATIC_TOTAL_BITS

# ---- rANS constants (CT-ANS1) ----
ANS_PROB_BITS = 14
ANS_TOTAL = 1 << ANS_PROB_BITS
ANS_LOW = 1 << 16         # state lower bound; u16-word renorm

# ---- Huffman (CT-HUF1) ----
HUF_MAX_BITS = 15

# ---- adaptive model (CT-RC2) ----
ADAPTIVE_INC_DEFAULT = 24
ADAPTIVE_LIMIT_LOG2_DEFAULT = 16

MAX_LANES_LOG2 = 13       # 8192 lanes


def pick_lanes(n: int, target_chunk: int = 2048, max_log2: int = MAX_LANES_LOG2) -> int:
    """Choose a power-of-two lane count for an n-byte input.

    Aim for ~target_chunk symbols per lane so per-lane overhead (flush + size
    table entry, ~4-5 bytes) stays below ~0.25% of the compressed size, while
    large inputs fill the device with thousands of lanes.
    """
    if n <= 0:
        return 1
    k = 1
    while k * 2 <= (n + target_chunk - 1) // target_chunk and (1 << max_log2) > k:
        k *= 2
    return k


def adaptive_params_for(k: int, inc: int = ADAPTIVE_INC_DEFAULT,
                        limit_log2: int = ADAPTIVE_LIMIT_LOG2_DEFAULT) -> tuple[int, int]:
    """(inc, limit_log2) such that 2^limit >= 4*K*inc (rescale headroom) and
    limit <= 24 (coding precision: range/total >= 2^8 at MIN_RANGE 2^24)."""
    limit = limit_log2
    while (1 << limit) < 4 * k * inc:
        limit += 1
    while limit > 24 and inc > 1:
        inc //= 2
        limit -= 1
    return inc, min(limit, 24)
