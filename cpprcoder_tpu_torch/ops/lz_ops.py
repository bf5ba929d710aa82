"""CT-LZ4 (SLZ4) in PyTorch (counterpart of cpprcoder_tpu/ops/lz_ops.py's
v1 and v2 parses and decode): LZ77 over independent segments in the LZ4
block format.

Format and parses: reference/slz4_ref.py (`parse_segment`, v1, and
`parse_segment_v2`). Encode, all batched over the segments as rows [n_segs,
W] on one device:
  1. the match table, (lcp, cand) a position:
     - v2 (kernel K on the card, ops/lz_kernels.py `match_v2`; its plain
       version `match_table`, tensor code: the words w0..w7 and the hash
       ladder, one stable sort of each row by (past the segment, w0..w3,
       position) in three passes of torch.sort, the adjacent ranks' lcp,
       the best of the up-to-4-up and up-to-2-down rank neighbours,
       scattered back to position order);
     - v1 (`match_table_v1`, kernel Z on the card, ops/lz_kernels.py): the
       nearest earlier position with the same 4 bytes within MAX_DISTANCE,
       and the exact lcp;
  2. kernel P, the walk (ops/lz_kernels.py): from the match table it
     applies the walk's rule a position (`walk_inputs`: `valid`, the length
     capped at END_LITERALS before the end, the position-local lazy rule,
     step = the length at a match, else 1) and lists each segment's
     matches;
  3. kernel Q, the clamp and the bytes, into a payload of the worst-case
     length; the sizes go to the host, then the payload's first sum(sizes)
     bytes.
Decode parses the header on the host, copies the payload to the device
once and runs kernel R, which checks every segment; a segment it refuses
raises CorruptContainerError.

The JAX package's limits are not carried over: any seg_log2 (its v2 walk
needs 2^seg_log2 >= 128, C2), no 2^18-token bound on the serializer (C1)
and no 2^26-byte cap on the decode; global offsets are int64. Its v1 lcp is
a hash estimate clamped after the walk; here it is exact, as the oracle's.
Segments are rows of W = 2^seg_log2 positions (W = n when there is one
segment); the last row is zero past its length, and the sort's first key
keeps those positions after every real one.
"""

from __future__ import annotations

import numpy as np
import torch

from cpprcoder_tpu_torch.core.bytesutil import (
    ByteReader,
    ByteWriter,
    CorruptContainerError,
    as_u8,
)
from cpprcoder_tpu_torch.core.hashing import M, mul_u32
from cpprcoder_tpu_torch.reference.slz4_ref import (
    D_DN,
    D_UP,
    END_LITERALS,
    LADDER_LO,
    LAST_MATCH_GUARD,
    LCP_CAP,
    MAX_DISTANCE,
    MIN_MATCH,
    W_EXACT,
)

MAX_WIDTH = 1 << 30      # a segment's positions are int32 in the kernels


def _shl(a: torch.Tensor, h: int, fill=0) -> torch.Tensor:
    """a[:, i] -> a[:, i + h], `fill` past each row's end."""
    out = torch.full_like(a, fill)
    if h < a.shape[1]:
        out[:, :a.shape[1] - h] = a[:, h:]
    return out


def _shr(a: torch.Tensor, h: int, fill=0) -> torch.Tensor:
    """a[:, k] -> a[:, k + h] (toward higher ranks), `fill` at the left."""
    out = torch.full_like(a, fill)
    if h < a.shape[1]:
        out[:, h:] = a[:, :a.shape[1] - h]
    return out


def _mix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    h = (mul_u32(a, 0x9E3779B1) + mul_u32(b, 0x85EBCA77)) & M
    return mul_u32(h ^ (h >> 15), 0x27D4EB2F)


def operands(rows: torch.Tensor):
    """rows uint8 [n, W] -> the words w0..w7 (big-endian packs of the bytes
    at 4k..4k+3, int64) and the ladder operands (ext_p << 16 | ref_p for p
    = LADDER_LO..11: the 16-bit window hashes H_p and H_{p-1} at p + 2^p,
    int64), zero past each row, as slz4_ref._sort_operands_np."""
    u = rows.to(torch.int64)
    words = [(_shl(u, 4 * k) << 24) | (_shl(u, 4 * k + 1) << 16)
             | (_shl(u, 4 * k + 2) << 8) | _shl(u, 4 * k + 3)
             for k in range(W_EXACT)]
    hs = [u]
    for r in range(11):
        hs.append(_mix(hs[-1], _shl(hs[-1], 1 << r)))
    ladder = [((_shl(hs[p], 1 << p) & 0xFFFF) << 16)
              | (_shl(hs[p - 1], 1 << p) & 0xFFFF)
              for p in range(LADDER_LO, 12)]
    return words, ladder


def _sorted_order(words, pad: torch.Tensor | None) -> torch.Tensor:
    """Each row's positions in the order of (pad, w0, w1, w2, w3, position):
    stable sorts from the least significant key up. The u32 pairs sort as
    int64 keys (w_hi - 2^31) * 2^32 + w_lo, in unsigned order."""
    perm = None
    keys = [(words[2] - (1 << 31)) * (1 << 32) + words[3],
            (words[0] - (1 << 31)) * (1 << 32) + words[1]]
    if pad is not None:
        keys.append(pad.to(torch.int64))
    for key in keys:
        if perm is not None:
            key = key.gather(1, perm)
        idx = torch.sort(key, dim=1, stable=True).indices
        perm = idx if perm is None else perm.gather(1, idx)
    return perm


def _adjacent_lcp(ws, lads, p_s, lens):
    """lcp of each sorted rank with the one before it (rank 0: 0) by the v2
    spec: exact below 32 bytes by the words, the hash ladder beyond, capped
    by the segment's length and LCP_CAP (slz4_ref._alcp_np)."""
    n, w = p_s.shape
    lcp = torch.zeros((n, w), dtype=torch.int64, device=p_s.device)
    done = torch.zeros((n, w), dtype=torch.bool, device=p_s.device)
    for k in range(W_EXACT):
        x = ws[k] ^ _shr(ws[k], 1)
        neq = x != 0
        inw = torch.where((x >> 24) != 0, 0, torch.where(
            (x >> 16) & 0xFF != 0, 1, torch.where((x >> 8) & 0xFF != 0, 2, 3)))
        lcp = torch.where(~done & neq, 4 * k + inw, lcp)
        done |= neq
    cur = torch.full((n, w), 4 * W_EXACT, dtype=torch.int64, device=p_s.device)
    alive = ~done
    for i, p in enumerate(range(LADDER_LO, 12)):
        px = lads[i] ^ _shr(lads[i], 1)
        e = (px >> 16) == 0
        r = (px & 0xFFFF) == 0
        nxt = torch.where(e, 1 << (p + 1), cur + torch.where(r, 1 << (p - 1), 0))
        cur = torch.where(alive, nxt, cur)
        alive &= e
    lcp = torch.where(done, lcp, cur.clamp(max=LCP_CAP))
    cap = lens[:, None] - torch.maximum(p_s, _shr(p_s, 1, w))
    lcp = torch.minimum(lcp, cap.clamp(min=0))
    lcp[:, 0] = 0
    return lcp


def match_table(rows: torch.Tensor, lens: torch.Tensor):
    """Per-position (lcp, cand) of the v2 spec (slz4_ref.match_table_v2),
    rows uint8 [n, W] with lens int64 [n] -> int64 [n, W] each (cand -1:
    none); the plain version of kernel K. Positions past a row's length
    sort after its real ones and get no candidate that counts."""
    n, w = rows.shape
    dev = rows.device
    pos = torch.arange(w, device=dev).expand(n, w)
    words, ladder = operands(rows)
    pad = pos >= lens[:, None]
    p_s = _sorted_order(words, pad if bool(pad.any()) else None)
    ws = [t.gather(1, p_s) for t in words]
    lads = [t.gather(1, p_s) for t in ladder]
    del words, ladder
    al = _adjacent_lcp(ws, lads, p_s, lens)
    f_s = p_s + MIN_MATCH > lens[:, None]
    best_l = torch.zeros((n, w), dtype=torch.int64, device=dev)
    best_c = torch.full((n, w), -1, dtype=torch.int64, device=dev)

    def consider(c, f, length):
        nonlocal best_l, best_c
        better = ((c >= 0) & (c < p_s) & (p_s - c <= MAX_DISTANCE) & ~f
                  & (length >= MIN_MATCH) & (length > best_l))
        best_l = torch.where(better, length, best_l)
        best_c = torch.where(better, c, best_c)

    l_up = al
    for d in range(1, D_UP + 1):
        if d > 1:
            l_up = torch.minimum(l_up, _shr(al, d - 1))
        consider(_shr(p_s, d, -1), _shr(f_s, d, True), l_up)
    l_dn = None
    for d in range(1, D_DN + 1):
        nx = _shl(al, d)
        l_dn = nx if d == 1 else torch.minimum(l_dn, nx)
        consider(_shl(p_s, d, -1), _shl(f_s, d, True), l_dn)
    lcp = torch.empty_like(best_l).scatter_(1, p_s, best_l)
    cand = torch.empty_like(best_c).scatter_(1, p_s, best_c)
    return lcp, cand


LCP_CHUNK = 64   # bytes match_table_v1 compares a chain a round


def match_table_v1(rows: torch.Tensor, lens: torch.Tensor):
    """Per-position (lcp, cand) of the v1 spec (slz4_ref.parse_segment),
    rows uint8 [n, W] with lens int64 [n] -> int64 [n, W] each; the plain
    version of kernel Z. For p with p + 4 <= L, cand[p] is the largest j <
    p with j + 4 <= L and the same 4 bytes, if p - j <= MAX_DISTANCE;
    there lcp[p] is the exact common prefix of the bytes at j and at p
    (overlap allowed), capped at LCP_CAP and at L - p. Elsewhere cand is
    -1 and lcp 0.

    The candidates: one stable sort of each row by (not indexable, the 4
    bytes), then the adjacent rank. The lcp by chains: where cand[p] =
    cand[p - 1] + 1 the two share their first mismatch (the 4 bytes at
    every position of the chain match), so each maximal chain compares
    bytes once from 4 past its last position, LCP_CHUNK a round, up to
    LCP_CAP past it or the segment's end."""
    n, w = rows.shape
    dev = rows.device
    pos = torch.arange(w, device=dev).expand(n, w)
    ln = lens[:, None]
    u = rows.to(torch.int64)
    key = (u << 24) | (_shl(u, 1) << 16) | (_shl(u, 2) << 8) | _shl(u, 3)
    key = torch.where(pos + MIN_MATCH <= ln, key, 1 << 32)
    s_key, p_s = torch.sort(key, dim=1, stable=True)
    same = (s_key == _shr(s_key, 1, -1)) & (s_key < 1 << 32)
    c_s = torch.where(same, _shr(p_s, 1, -1), -1)
    cand = torch.empty_like(c_s).scatter_(1, p_s, c_s)
    cand = torch.where(pos - cand <= MAX_DISTANCE, cand, -1)
    has = cand >= 0
    d = pos - cand
    cont = has & _shr(has, 1, False) & (_shr(d, 1) == d)
    last = has & ~_shl(cont, 1, False)
    rr, ee = last.nonzero(as_tuple=True)
    dd = d[rr, ee]
    lim = torch.minimum(lens[rr], ee + LCP_CAP)
    flat = rows.reshape(-1)
    base = rr * w
    mm = lim.clone()               # each chain's first mismatch, or lim
    k = ee + MIN_MATCH
    act = torch.arange(ee.numel(), device=dev)
    step = torch.arange(LCP_CHUNK, device=dev)
    act = act[k[act] < lim[act]]
    while act.numel():
        kk = k[act, None] + step
        ok = kk < lim[act, None]
        at = torch.where(ok, base[act, None] + kk, 0)
        bad = (flat[at] != flat[torch.where(ok, at - dd[act, None], 0)]) & ok
        hit = bad.any(1)
        mm[act[hit]] = (kk.gather(1, bad.to(torch.uint8).argmax(1)[:, None])
                        [:, 0])[hit]
        k[act] += LCP_CHUNK
        act = act[~hit]
        act = act[k[act] < lim[act]]
    at_end = torch.zeros((n, w), dtype=torch.int64, device=dev)
    at_end[rr, ee] = mm
    nxt = torch.where(last, pos, w - 1).flip(1).cummin(1).values.flip(1)
    cap = torch.minimum(ln - pos, torch.full_like(pos, LCP_CAP))
    lcp = torch.where(has, torch.minimum(cap, at_end.gather(1, nxt) - pos), 0)
    return lcp, cand


def walk_inputs(lcp: torch.Tensor, cand: torch.Tensor, lens: torch.Tensor,
                lazy: bool = True):
    """The match table's lcp, cand int64 [n, W] and lens int64 [n] -> step,
    off int32 [n, W]: the walk's inputs, the first step of kernel P's plain
    version (kernel P applies the same rule a position). A match at p
    (valid, and not deferred by the lazy rule) has step = its length
    (capped END_LITERALS before the segment's end, unclamped) and off = p -
    its candidate; every other position has step 1 and off 0."""
    w = lcp.shape[1]
    pos = torch.arange(w, device=lcp.device)[None, :]
    ln = lens[:, None]
    mlen = torch.minimum(lcp, ln - END_LITERALS - pos)
    valid = (cand >= 0) & (pos <= ln - LAST_MATCH_GUARD) & (mlen >= MIN_MATCH)
    if lazy:
        valid = valid & ~(_shl(valid, 1, False) & (_shl(mlen, 1) > mlen))
    step = torch.where(valid, mlen, 1).to(torch.int32)
    off = torch.where(valid, pos - cand, 0).to(torch.int32)
    return step, off


def segment_rows(x: torch.Tensor, seg_log2: int):
    """x uint8 [n] (n >= 1) -> rows uint8 [n_segs, W] (zero past n) and
    lens int64 [n_segs]. W = 2^seg_log2, or n when that is one segment."""
    n = x.numel()
    s = 1 << seg_log2
    n_segs = -(-n // s)
    w = s if n_segs > 1 else n
    if w > MAX_WIDTH:
        raise ValueError(f"segments of {w} bytes: at most 2^30 a segment")
    buf = torch.zeros(n_segs * w, dtype=torch.uint8, device=x.device)
    buf[:n] = x
    lens = torch.clamp(n - torch.arange(n_segs, device=x.device) * w, max=w)
    return buf.view(n_segs, w), lens


def slz4_encode(data, seg_log2: int = 17, lazy: bool = True,
                parse: str = "v2", *, device) -> bytes:
    """CT-LZ4 container of `data` by the v2 or the v1 parse, on `device`:
    the match table (v2: kernel K; v1: kernel Z), then kernels P and Q, on
    CUDA, and their plain versions on the CPU. Same bytes as
    slz4_ref.slz4_encode(data, seg_log2, lazy, parse)."""
    from cpprcoder_tpu_torch.ops import lz_kernels

    if parse not in ("v1", "v2"):
        raise ValueError(f"parse={parse!r}: 'v1' or 'v2'")
    x = as_u8(data)
    n = len(x)
    if n > M:
        raise ValueError(f"slz4 container rawSize is u32; input is {n} bytes")
    if not 0 <= seg_log2 <= 255:
        raise ValueError(f"seg_log2 {seg_log2} does not fit the header's u8")
    s = 1 << seg_log2
    n_segs = -(-n // s)
    w = ByteWriter().u32(n).u8(seg_log2).u32(n_segs)
    if n_segs == 0:
        return w.getvalue()
    rows, lens = segment_rows(torch.from_numpy(x.copy()).to(device), seg_log2)
    table = (lz_kernels.match_v2(rows, lens) if parse == "v2"
             else lz_kernels.match_v1(rows, lens))
    tokens = lz_kernels.walk(*table, lens, lazy)
    payload, sizes = lz_kernels.serialize(rows, lens, *tokens)
    sizes = sizes.cpu().numpy()
    w.u32s(sizes)
    w.raw(payload[:int(sizes.sum())].cpu().numpy().tobytes())
    return w.getvalue()


def slz4_decode(blob, *, device) -> bytes:
    """Any CT-LZ4 container (either parse, any seg_log2) -> the bytes, by
    kernel R on CUDA or its plain version on the CPU. Raises
    CorruptContainerError on a malformed container."""
    from cpprcoder_tpu_torch.ops import lz_kernels

    r = ByteReader(blob)
    n = r.u32()
    seg_log2 = r.u8()
    n_segs = r.u32()
    s = 1 << seg_log2
    if n_segs != -(-n // s):
        raise CorruptContainerError(
            f"slz4: {n_segs} segments for n={n} at seg_log2={seg_log2}")
    if n_segs == 0:
        return b""
    sizes = r.u32s(n_segs).astype(np.int64)
    payload = r.raw(int(sizes.sum()))
    bases = np.cumsum(sizes) - sizes
    out, err = lz_kernels.decode(
        torch.from_numpy(payload.copy()).to(device),
        torch.from_numpy(bases).to(device), torch.from_numpy(sizes).to(device),
        n, s)
    err = err.cpu().numpy()
    if err.any():
        i = int(np.flatnonzero(err)[0])
        raise CorruptContainerError(
            f"slz4: segment {i} of {n_segs}: "
            f"{lz_kernels.ERRORS[int(err[i])]}")
    return out.cpu().numpy().tobytes()
