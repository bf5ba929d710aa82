"""Oracle (host, exact) implementation of CT-LZ4 (FORMATS.md).

LZ4 block format (bit-compatible with test/slz4.h:237-358,520-592 and the
public LZ4 spec), produced by a deterministic parse that both backends
implement identically:

  candidate c(i) = max{ j < i in the same segment : bytes4(j) == bytes4(i) }
  valid(i)  ⟺  c(i) exists ∧ i-c(i) ≤ 65535 ∧ lcp(i,c(i)) ≥ 4 ∧ i ≤ L-12
  mlen(i)   = min(lcp(i, c(i)), LCP_CAP, L - 5 - i)
  greedy: from pos 0, take the match if valid else advance one literal.
  lazy (default): at a valid i, defer by one literal when valid(i+1) and
  mlen(i+1) > mlen(i) — a position-local rule, so it stays data-parallel.

LCP_CAP = 4096 bounds the rank-doubling depth on device (longer repeats
chain through consecutive capped matches at ~6 bytes per 4 KiB — negligible).

Unlike the reference's 16K single-probe hash dictionary (test/slz4.h:204-234,
which loses matches to collisions and replacement), candidates here are
exact, so the parse never misses the nearest 4-byte match. Matches never
cross segment boundaries; concatenated segment blocks form one valid LZ4
block (offsets stay in-segment).

(The port's own copy of cpprcoder_tpu/reference/slz4_ref.py, whole.)
"""

from __future__ import annotations

import numpy as np

from cpprcoder_tpu_torch.core.bytesutil import ByteReader, ByteWriter, as_u8

MAX_DISTANCE = 65535
MIN_MATCH = 4
END_LITERALS = 5
LAST_MATCH_GUARD = 12
LCP_CAP = 4096


def parse_segment(seg: np.ndarray, lazy: bool = True):
    """Parse per spec. Returns tokens as a list of
    (lit_start, lit_len, match_len, offset); final token has match_len == 0."""
    L = len(seg)
    tokens = []
    last: dict[bytes, int] = {}
    i = 0
    lit_start = 0
    bs = seg.tobytes()
    # candidate map must observe EVERY position < current, including skipped
    # ones, so advance it position-by-position
    next_to_index = 0

    def index_up_to(p):
        nonlocal next_to_index
        while next_to_index < p and next_to_index + MIN_MATCH <= L:
            last[bs[next_to_index:next_to_index + MIN_MATCH]] = next_to_index
            next_to_index += 1

    def match_at(p):
        """(mlen, offset) of the valid match at p, or (0, 0)."""
        if p > L - LAST_MATCH_GUARD:
            return 0, 0
        index_up_to(p)
        j = last.get(bs[p:p + MIN_MATCH])
        if j is None or p - j > MAX_DISTANCE:
            return 0, 0
        lcp = 0
        while p + lcp < L and lcp < LCP_CAP and bs[j + lcp] == bs[p + lcp]:
            lcp += 1
        if lcp < MIN_MATCH:
            return 0, 0
        return min(lcp, L - END_LITERALS - p), p - j

    while i < L:
        mlen, off = match_at(i)
        if mlen and lazy and match_at(i + 1)[0] > mlen:
            mlen = 0  # defer: emit one literal, re-decide at i+1
        if mlen:
            tokens.append((lit_start, i - lit_start, mlen, off))
            i += mlen
            lit_start = i
        else:
            i += 1
    tokens.append((lit_start, L - lit_start, 0, 0))
    return tokens


# --------------------------------------------------------------- parse v2
# CT-SLZ4 v2 "suffix-neighborhood" parse (the TPU-fast spec; same container
# and LZ4 block format, different — and stronger — match selection).
#
# All positions of a segment are sorted by (first 16 bytes, position).  Candidates for position i are its rank neighbors at strides
# 1..D_UP above and 1..D_DN below; the common-prefix length against a
# neighbor is the min of ADJACENT-pair lcps between their ranks (exact to
# 32 bytes via packed words, then a power-of-two hash ladder (16-bit
# window hashes) with one refinement level — the ladder is part of the
# spec: both backends compare the same hash chains, so containers are
# byte-identical by construction, not probabilistically; a 16-bit false
# equality only costs a slightly worse match, never validity).  A final byte-exact clamp bounds
# every selected match at its first real mismatch, so a hash collision can
# only shorten a match — output is always valid LZ4.
#
# Ratio beats the v1 nearest-exact-key parse on every Canterbury file
# (alice29 0.473 vs 0.544, kennedy 0.319 vs 0.348) because rank neighbors
# surface the LONGEST nearby match, not the nearest 4-byte one.

D_UP = 4
D_DN = 2
W_EXACT = 8          # exact words: 32-byte exact prefix compare
LADDER_LO = 5        # hash ladder: spans 2^6 .. 2^12 via p = 5..11


def _mix_np(a, b, c1, c2):
    h = (a.astype(np.uint64) * c1 + b.astype(np.uint64) * c2) & 0xFFFFFFFF
    h = ((h ^ (h >> 15)) * 0x27D4EB2F) & 0xFFFFFFFF
    return h.astype(np.uint32)


def _shl_np(a, h):
    out = np.zeros_like(a)
    if h < len(a):
        out[: len(a) - h] = a[h:]
    return out


def _sort_operands_np(seg: np.ndarray):
    """Words w0..w7 (big-endian 4-byte packs at offsets 4k), hash chain
    H_r (span 2^r), and the shifted ladder operands ext_p = H_p << 2^p,
    ref_p = H_{p-1} << 2^p. Zero-padding beyond the segment is part of the
    spec (the length cap in _alcp_np masks it)."""
    u = seg.astype(np.uint32)
    w = [(_shl_np(u, 4 * k) << 24) | (_shl_np(u, 4 * k + 1) << 16)
         | (_shl_np(u, 4 * k + 2) << 8) | _shl_np(u, 4 * k + 3)
         for k in range(W_EXACT)]
    H = [u.copy()]
    for r in range(12):
        H.append(_mix_np(H[-1], _shl_np(H[-1], 1 << r),
                         0x9E3779B1, 0x85EBCA77))
    ext = {p: _shl_np(H[p], 1 << p) & 0xFFFF
           for p in range(LADDER_LO, 12)}
    ref = {p: _shl_np(H[p - 1], 1 << p) & 0xFFFF
           for p in range(LADDER_LO, 12)}
    return w, ext, ref


def _alcp_np(w, ext, ref, a, b, L):
    """Spec lcp of position pairs (a, b): exact below 32 via the words,
    hash ladder beyond (floor power-of-two plus one half-step refinement),
    capped by segment length and LCP_CAP."""
    lcp = np.zeros(len(a), np.int32)
    done = np.zeros(len(a), bool)
    for k in range(W_EXACT):
        x = w[k][a] ^ w[k][b]
        neq = x != 0
        inw = np.where((x >> 24) != 0, 0,
                       np.where((x >> 16) & 0xFF, 1,
                                np.where((x >> 8) & 0xFF, 2, 3)))
        lcp = np.where(~done & neq, 4 * k + inw, lcp)
        done |= neq
    cur = np.full(len(a), 4 * W_EXACT, np.int32)
    alive = ~done
    for p in range(LADDER_LO, 12):
        e = ext[p][a] == ext[p][b]
        r = ref[p][a] == ref[p][b]
        nxt = np.where(e, 1 << (p + 1), cur + np.where(r, 1 << (p - 1), 0))
        cur = np.where(alive, nxt, cur)
        alive &= e
    lcp = np.where(done, lcp, np.minimum(cur, LCP_CAP))
    cap = L - np.maximum(a, b)
    return np.minimum(lcp, np.maximum(cap, 0)).astype(np.int32)


def match_table_v2(seg: np.ndarray):
    """Per-position (lcp, cand) arrays of the v2 spec (cand = -1: none)."""
    L = len(seg)
    w, ext, ref = _sort_operands_np(seg)
    pos = np.arange(L, dtype=np.int32)
    flag = (pos + MIN_MATCH > L).astype(np.uint32)
    order = np.lexsort((pos, w[3], w[2], w[1], w[0]))
    p_s = pos[order]
    f_s = flag[order]
    al = np.zeros(L, np.int32)
    if L > 1:
        al[1:] = _alcp_np(w, ext, ref, p_s[:-1], p_s[1:], L)
    best_l = np.zeros(L, np.int32)
    best_c = np.full(L, -1, np.int32)

    def consider(c, f, l):
        nonlocal best_l, best_c
        ok = ((c >= 0) & (c < p_s) & (p_s - c <= MAX_DISTANCE)
              & (f == 0) & (l >= MIN_MATCH))
        better = ok & (l > best_l)
        best_l = np.where(better, l, best_l)
        best_c = np.where(better, c, best_c)

    l_up = None
    for d in range(1, D_UP + 1):
        if d == 1:
            l_up = al.copy()
        else:
            prev = np.roll(al, d - 1)
            prev[: d - 1] = 0
            l_up = np.minimum(l_up, prev)
        c = np.full(L, -1, np.int32)
        c[d:] = p_s[:-d]
        f = np.zeros(L, np.uint32)
        f[d:] = f_s[:-d]
        consider(c, f, l_up)
    l_dn = None
    for d in range(1, D_DN + 1):
        nx = np.roll(al, -d)
        nx[L - d:] = 0
        l_dn = nx if d == 1 else np.minimum(l_dn, nx)
        c = np.full(L, -1, np.int32)
        c[:-d] = p_s[d:]
        f = np.zeros(L, np.uint32)
        f[:-d] = f_s[d:]
        consider(c, f, l_dn)
    lcp = np.zeros(L, np.int32)
    cand = np.full(L, -1, np.int32)
    lcp[p_s] = best_l
    cand[p_s] = best_c
    return lcp, cand


def parse_segment_v2(seg: np.ndarray, lazy: bool = True):
    """Greedy + 1-step-lazy walk over the v2 match table, byte-exact clamp
    on selected matches (the walk advances by the UNclamped length; the
    next literal run resumes at the clamped end — mirrors the device
    parse exactly)."""
    L = len(seg)
    lcp, cand = match_table_v2(seg)
    pos = np.arange(L, dtype=np.int32)
    valid = (cand >= 0) & (pos <= L - LAST_MATCH_GUARD)
    mlen = np.minimum(lcp, L - END_LITERALS - pos)
    valid &= mlen >= MIN_MATCH
    bs = seg.tobytes()
    tokens = []
    i = 0
    lit_start = 0
    while i < L:
        m = int(mlen[i]) if valid[i] else 0
        if m and lazy and i + 1 < L and \
                (int(mlen[i + 1]) if valid[i + 1] else 0) > m:
            m = 0
        if m:
            c = int(cand[i])
            j = 0
            while j < m and bs[c + j] == bs[i + j]:
                j += 1
            tokens.append((lit_start, i - lit_start, j, i - c))
            i += m
            lit_start = tokens[-1][0] + tokens[-1][1] + j
        else:
            i += 1
    tokens.append((lit_start, L - lit_start, 0, 0))
    return tokens


def serialize_tokens(seg: np.ndarray, tokens) -> bytes:
    out = bytearray()
    for lit_start, lit_len, mlen, off in tokens:
        lit_tok = min(lit_len, 15)
        m_tok = min(mlen - MIN_MATCH, 15) if mlen else 0
        out.append((lit_tok << 4) | m_tok)
        if lit_len >= 15:
            rem = lit_len - 15
            while rem >= 255:
                out.append(255)
                rem -= 255
            out.append(rem)
        out += seg[lit_start:lit_start + lit_len].tobytes()
        if mlen:
            out.append(off & 0xFF)
            out.append(off >> 8)
            if mlen - MIN_MATCH >= 15:
                rem = mlen - MIN_MATCH - 15
                while rem >= 255:
                    out.append(255)
                    rem -= 255
                out.append(rem)
    return bytes(out)


def decode_block(block: bytes, expected: int) -> bytes:
    """Standard LZ4 block decoder (safety-checked)."""
    out = bytearray()
    pos = 0
    n = len(block)
    while pos < n:
        token = block[pos]
        pos += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = block[pos]
                pos += 1
                lit += b
                if b != 255:
                    break
        out += block[pos:pos + lit]
        pos += lit
        if pos >= n:
            break
        off = block[pos] | (block[pos + 1] << 8)
        pos += 2
        if off == 0:
            raise ValueError("invalid offset 0")
        mlen = (token & 0xF) + MIN_MATCH
        if (token & 0xF) == 15:
            while True:
                b = block[pos]
                pos += 1
                mlen += b
                if b != 255:
                    break
        start = len(out) - off
        if start < 0:
            raise ValueError("offset past start")
        for t in range(mlen):
            out.append(out[start + t])
    if len(out) != expected:
        raise ValueError(f"decoded {len(out)} != expected {expected}")
    return bytes(out)


def slz4_encode(data, seg_log2: int = 17, lazy: bool = True,
                parse: str = "v1") -> bytes:
    x = as_u8(data)
    n = len(x)
    s = 1 << seg_log2
    w = ByteWriter().u32(n).u8(seg_log2)
    n_segs = -(-n // s) if n else 0
    w.u32(n_segs)
    parse_fn = parse_segment_v2 if parse == "v2" else parse_segment
    blocks = []
    for i in range(n_segs):
        seg = x[i * s:(i + 1) * s]
        blocks.append(serialize_tokens(seg, parse_fn(seg, lazy)))
    w.u32s([len(b) for b in blocks])
    for b in blocks:
        w.raw(b)
    return w.getvalue()


def slz4_decode(blob) -> bytes:
    r = ByteReader(blob)
    n = r.u32()
    seg_log2 = r.u8()
    s = 1 << seg_log2
    n_segs = r.u32()
    sizes = r.u32s(n_segs)
    out = bytearray()
    for i in range(n_segs):
        expected = min(s, n - i * s)
        out += decode_block(r.raw(int(sizes[i])).tobytes(), expected)
    return bytes(out)
