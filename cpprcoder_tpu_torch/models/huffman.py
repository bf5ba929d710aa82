"""Canonical length-limited Huffman table construction, on the host (the
port's own copy of cpprcoder_tpu/models/huffman.py).

Exact package-merge gives length-limited (<= 15 bit) optimal code lengths,
then canonical codes are assigned. Codes are written LSB-first
(bit-reversed canonical codes), as FORMATS.md CT-HUF1 specifies.
"""

from __future__ import annotations

import numpy as np

from cpprcoder_tpu_torch.config import HUF_MAX_BITS


def package_merge_lengths(counts: np.ndarray, max_bits: int = HUF_MAX_BITS) -> np.ndarray:
    """Optimal length-limited code lengths via package-merge.

    counts: 256 nonnegative ints. Returns u8 lengths (0 for absent symbols).
    """
    counts = np.asarray(counts, dtype=np.int64)
    syms = np.nonzero(counts)[0]
    m = len(syms)
    lengths = np.zeros(256, dtype=np.uint8)
    if m == 0:
        return lengths
    if m == 1:
        lengths[syms[0]] = 1
        return lengths
    if (1 << max_bits) < m:
        raise ValueError("max_bits too small for alphabet")
    # each list item: (weight, per-symbol multiplicity vector over m symbols)
    base_w = counts[syms]
    order = np.argsort(base_w, kind="stable")
    item_w = base_w[order]
    item_c = np.eye(m, dtype=np.int32)[order]

    prev_w = np.zeros((0,), dtype=np.int64)
    prev_c = np.zeros((0, m), dtype=np.int32)
    for _ in range(max_bits):
        # package pairs from prev
        npair = len(prev_w) // 2
        pw = prev_w[: 2 * npair : 2] + prev_w[1 : 2 * npair : 2]
        pc = prev_c[: 2 * npair : 2] + prev_c[1 : 2 * npair : 2]
        w = np.concatenate([item_w, pw])
        c = np.concatenate([item_c, pc])
        o = np.argsort(w, kind="stable")
        prev_w, prev_c = w[o], c[o]
    take = 2 * (m - 1)
    # item_c columns are indexed by position in `syms`, so mult[j] is the
    # code length of syms[j]
    mult = prev_c[:take].sum(axis=0)
    lengths[syms] = mult.astype(np.uint8)
    assert lengths.max() <= max_bits
    assert np.isclose(np.sum(np.ldexp(1.0, -lengths[syms].astype(int))), 1.0)
    return lengths


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical codes (MSB-first convention) from lengths; u32[256]."""
    lengths = np.asarray(lengths, dtype=np.int64)
    codes = np.zeros(256, dtype=np.uint32)
    code = 0
    prev_len = 0
    for l, s in sorted((int(lengths[s]), s) for s in range(256) if lengths[s]):
        code <<= (l - prev_len)
        codes[s] = code
        code += 1
        prev_len = l
    return codes


def reverse_bits(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Bit-reverse each code within its length (LSB-first emission order)."""
    out = np.zeros(256, dtype=np.uint32)
    for s in range(256):
        l = int(lengths[s])
        c = int(codes[s])
        r = 0
        for _ in range(l):
            r = (r << 1) | (c & 1)
            c >>= 1
        out[s] = r
    return out


def build_encoder_table(counts, max_bits: int = HUF_MAX_BITS):
    """(lengths u8[256], lsb_codes u32[256])."""
    lengths = package_merge_lengths(counts, max_bits)
    codes = canonical_codes(lengths)
    return lengths, reverse_bits(codes, lengths)


def build_canonical_decode_tables(lengths: np.ndarray,
                                  max_bits: int = HUF_MAX_BITS):
    """Arithmetic canonical decoding tables:

    limits[l]  = (first_code[l] + count[l]) << (max_bits - l)  (l = 1..max)
    bases_l[l] = first_code[l] - rank_offset[l]
    perm[rank] = symbol, symbols sorted by (length, symbol)

    For a bit-reversed MSB-aligned window r: the code length is the smallest
    l with r < limits[l]; rank = (r >> (max_bits-l)) - bases_l[l];
    symbol = perm[rank]."""
    lengths = np.asarray(lengths, dtype=np.int64)
    counts = np.bincount(lengths, minlength=max_bits + 1)
    limits = np.zeros(max_bits + 1, dtype=np.uint32)
    bases_l = np.zeros(max_bits + 1, dtype=np.uint32)
    first = 0
    offset = 0
    for l in range(1, max_bits + 1):
        limits[l] = (first + counts[l]) << (max_bits - l)
        bases_l[l] = first - offset
        offset += counts[l]
        first = (first + counts[l]) << 1
    order = sorted((int(lengths[s]), s) for s in range(256) if lengths[s])
    perm = np.zeros(256, dtype=np.uint32)
    for rank, (_, s) in enumerate(order):
        perm[rank] = s
    return limits, bases_l, perm


def build_decoder_lut(lengths: np.ndarray, max_bits: int = HUF_MAX_BITS) -> np.ndarray:
    """LUT over the next max_bits (LSB-first) input bits -> (len<<8 | sym), u16.

    Entry for every bit pattern whose low bits match a code."""
    codes = canonical_codes(lengths)
    lsb = reverse_bits(codes, lengths)
    lut = np.zeros(1 << max_bits, dtype=np.uint16)
    for s in range(256):
        l = int(lengths[s])
        if l == 0:
            continue
        step = 1 << l
        pattern = int(lsb[s])
        fill = np.arange(pattern, 1 << max_bits, step, dtype=np.int64)
        lut[fill] = (l << 8) | s
    return lut
