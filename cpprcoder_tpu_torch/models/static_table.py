"""Static frequency-table construction (the port's own copy of
cpprcoder_tpu/models/static_table.py).

Normalizes a 256-bin histogram to an exact power-of-two total with every
present symbol getting frequency >= 1, by one deterministic
largest-remainder rounding that is u32-safe.

Spec (FORMATS.md normalization):
  1. pre-scale: shift = max(0, bitlen(n-1) - 14); c = counts >> shift;
     present symbols clamp to >= 1   (all intermediates then fit u32)
  2. floor-scale to T = 2^total_bits: f = c*T // n', r = c*T % n'
  3. present & f == 0 -> f = 1
  4. d = T - sum(f):
       d > 0: +1 to the d present symbols with largest r (ties: lower symbol)
       d < 0: take the deficit from the richest symbols (ties: lower symbol),
              draining each to 1 before moving to the next
  5. if one symbol holds all of T, cap it at T-1 and give 1 to (s+1) % 256
     (so values fit u16 headers; the spare slot is never coded)
"""

from __future__ import annotations

import numpy as np


def prescale_counts(counts: np.ndarray) -> np.ndarray:
    counts = np.asarray(counts, dtype=np.int64)
    n = int(counts.sum())
    if n == 0:
        return counts.astype(np.uint32)
    shift = max(0, int(n - 1).bit_length() - 14)
    c = counts >> shift
    c[(counts > 0) & (c == 0)] = 1
    return c.astype(np.uint32)


def normalize_freqs(counts: np.ndarray, total_bits: int) -> np.ndarray:
    """Scale 256 counts so they sum to exactly 2**total_bits (u32-safe)."""
    total = 1 << total_bits
    c = prescale_counts(counts).astype(np.int64)
    n = int(c.sum())
    if n == 0:
        return np.zeros(256, dtype=np.uint32)
    present = c > 0
    f = (c * total) // n
    r = (c * total) % n
    f[present & (f == 0)] = 1
    d = total - int(f.sum())
    if d > 0:
        # stable rank by remainder desc (ties: symbol asc); absent last
        r = np.where(present, r, -1)
        order = np.argsort(-r, kind="stable")
        rank = np.empty(256, dtype=np.int64)
        rank[order] = np.arange(256)
        f += (present & (rank < d)).astype(np.int64)
    elif d < 0:
        need = -d
        excess = np.where(present, f - 1, 0)
        order = np.argsort(-f, kind="stable")  # richest first, ties: symbol asc
        ex_sorted = excess[order]
        cum = np.cumsum(ex_sorted)
        take_sorted = np.clip(need - (cum - ex_sorted), 0, ex_sorted)
        take = np.zeros(256, dtype=np.int64)
        take[order] = take_sorted
        f -= take
    if f.max() == total:
        s = int(np.argmax(f))
        f[s] -= 1
        f[(s + 1) % 256] += 1
    assert int(f.sum()) == total
    return f.astype(np.uint32)


def exclusive_cumsum(freqs: np.ndarray) -> np.ndarray:
    """cum[s] = sum of freqs[:s]; 256 entries."""
    c = np.zeros(256, dtype=np.uint32)
    np.cumsum(freqs[:-1], out=c[1:], dtype=np.uint32)
    return c
