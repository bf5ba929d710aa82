"""Kernel K, CT-LZ4's v2 match table (csrc/lz_match_v2.cu), on the CPU: a
numpy model of its Hopper design held to its plain version
(lz_ops.match_table, whole arrays) and to the oracle
(slz4_ref.match_table_v2, a segment at a time).

The model follows the kernel launch for launch: count puts the w0 of each
position p < L (its 4 bytes, big-endian, zero from L on) into the row's
hash table (2W slots, linear probing from the mixed key's home slot; the
kernel adds a 2,048-position tile's count of a key at once) and gives it a
rank among its group's, but for the positions whose 16 key bytes are zero,
which it ranks in position order; zero gives the group of w0 = 0, where it
has such positions, its range (them first, then the others, which alone
are sorted) and clears its slot; alloc gives each group of 2 .. CAP
positions a range of the order from the bottom and each larger one a range
from the top, an entry of the large groups' list (its first tile) and
records the small group that crosses each CAP boundary; scatter writes
each grouped position's key (w1, w2, w3, p; p's top bit on rank 0) at its
group's offset plus its rank, into the order or, for a large group whose
merge passes are odd in number, the spare buffer; sort sorts each tile of
CAP keys of the small range (a key's segment: the group starts at or
before it in the tile) and of each large group, ITEMS keys a thread (the
kernel packs a key into 16 bytes up to W = 2^20: the same order), then the
merge rounds the tile needs (a merge path search a thread, ITEMS keys
merged serially), and flags each group's first rank; fix merges the two
pieces of each crossing group; the merge passes (runs of CAP, 2 CAP, ..)
inside each large group cut MCHUNK outputs by the warp's 32-way search and
merge them as the tile rounds do; al takes each rank's lcp with the rank
before it in its group from the keys and the row, leaving pairs equal on
32 bytes to the ladder and flagging their 4,096-position tiles; the ladder
builds the flagged tiles' records (H_1 .. H_11 in place over LADDER_SPAN
u32s, zero past L and past the span); the pick stages the positions of its
PICK ranks with 4 before and 2 after (-1 outside the two ranges), their al
(the ladder's pairs from the records), picks and writes each rank's
candidate packed at its position; out gives each position its (lcp, cand),
and (0, -1) where the scatter found no rank. Where the kernel's atomics
set an order (slots taken, ranks, the groups' places), the model takes
one: positions and slots in order, or a shuffle from `rng`. Keys compare
here by their rank in a lexsort of the same words, which orders them as
the kernel's comparison does. Change the model with the kernel."""

import numpy as np
import pytest
import torch

from conftest import CANTERBURY, corpus_file
from cpprcoder_tpu_torch.bench.lz_edges import (
    CAP, TAIL_BARRIER, colliding_keys, collisions, edge, group_of, home_slot)
from cpprcoder_tpu_torch.ops import lz_kernels, lz_ops
from cpprcoder_tpu_torch.reference import slz4_ref
from cpprcoder_tpu_torch.reference.slz4_ref import LCP_CAP, MAX_DISTANCE

ITEMS = 8                               # csrc/lz_match_v2.cu
SORT_THREADS = CAP // ITEMS
M_ITEMS, M_THREADS = 8, 256
MCHUNK = M_ITEMS * M_THREADS
LADDER_TILE, LADDER_SPAN = 4096, 4096 + LCP_CAP
PICK = 256
BIG = np.iinfo(np.int64).max            # the key past every real one


# ------------------------------------------------------------ the model

def _words(row, L):
    """w0..w3: the big-endian words of the 16 bytes at each p < L, zero
    from L on."""
    pad = np.zeros(L + 16, np.uint8)
    pad[:L] = row[:L]
    b = np.lib.stride_tricks.sliding_window_view(pad, 16)[:L].astype(np.int64)
    return [(b[:, 4 * k] << 24) | (b[:, 4 * k + 1] << 16)
            | (b[:, 4 * k + 2] << 8) | b[:, 4 * k + 3] for k in range(4)]


def passes_of(g):
    """Merge passes of a large group of g positions."""
    k, width = 0, CAP
    while width < g:
        k, width = k + 1, 2 * width
    return k


def _count_model(w0, s, order):
    """Launch 1: positions in `order` into s slots -> (slot, rank) of each
    position, and each slot's count."""
    cnt = np.zeros(s, np.int64)
    where = {}
    home = home_slot(w0, s)
    slot = np.empty(len(w0), np.int64)
    rank = np.empty(len(w0), np.int64)
    for p in order:
        k = int(w0[p])
        q = where.get(k)
        if q is None:
            q = int(home[p])
            while cnt[q]:
                q = q + 1 if q + 1 < s else 0
            where[k] = q
        slot[p], rank[p] = q, cnt[q]
        cnt[q] += 1
    return slot, rank, cnt


def _merge_path(a, a_len, b, b_len, diag):
    """ct::merge_path for every thread at once (arrays of one length)."""
    lo = np.maximum(0, diag - b_len)
    hi = np.minimum(diag, a_len)
    while (lo < hi).any():
        go = lo < hi
        mid = (lo + hi) >> 1
        bi = np.where(go, diag - 1 - mid, 0)
        ai = np.where(go, mid, 0)
        b_first = b(bi) < a(ai)
        hi = np.where(go & b_first, mid, hi)
        lo = np.where(go & ~b_first, mid + 1, lo)
    return lo


def _warp_merge_path(a, a_len, b, b_len, diag):
    """ct::warp_merge_path: 32 points a round."""
    lo, hi = max(0, diag - b_len), min(diag, a_len)
    while lo < hi:
        step = (hi - lo + 31) >> 5
        m = lo + step * np.arange(32)
        m = m[m < hi]
        c = int(np.count_nonzero(~(b(diag - 1 - m) < a(m))))
        if c == 0:
            hi = lo
        else:
            hi = min(hi, lo + c * step)
            lo += (c - 1) * step + 1
    return lo


def _serial_merge(a, a_len, b, b_len, i, j, items):
    """ct::serial_merge for every thread: -> keys [threads, items]."""
    out = []
    for _ in range(items):
        jj, ii = np.minimum(j, max(b_len - 1, 0)), np.minimum(i, max(a_len - 1, 0))
        y = b(jj) if b_len else np.full_like(j, BIG)
        x = a(ii) if a_len else np.full_like(i, BIG)
        take_b = (j < b_len) & ((i >= a_len) | (y < x))
        out.append(np.where(take_b, y, x))
        j = j + take_b
        i = i + ~take_b
    return np.stack(out, 1)


def _merge(a, b, items, threads):
    """A CTA's merge of sorted runs a and b (staged in shared memory): each
    thread's cut by merge path, then `items` keys serially."""
    sh = np.concatenate([a, b])
    na, nb, cnt = len(a), len(b), len(a) + len(b)
    d = np.minimum(items * np.arange(threads), cnt)
    i = _merge_path(lambda q: sh[q], na, lambda q: sh[na + q], nb, d)
    out = _serial_merge(lambda q: sh[q], na, lambda q: sh[na + q], nb, i,
                        d - i, items)
    at = d[:, None] + np.arange(items)
    ok = at < cnt
    res = np.empty(cnt, np.int64)
    res[at[ok]] = out[ok]
    return res


def _tile_sort(keys):
    """A sort CTA on cnt keys: ITEMS a thread sorted in registers, then the
    merge rounds up to n, the least power of two >= max(cnt, ITEMS)."""
    cnt = len(keys)
    n = ITEMS
    while n < cnt:
        n *= 2
    full = np.full(n, BIG)
    full[:cnt] = keys
    it = np.sort(full.reshape(-1, ITEMS), axis=1)
    t0 = ITEMS * np.arange(n // ITEMS)
    width = ITEMS
    while width < n:
        sh = it.reshape(-1)
        gs = t0 & ~(2 * width - 1)
        d = t0 - gs
        i = _merge_path(lambda q: sh[gs + q], width,
                        lambda q: sh[gs + width + q], width, d)
        it = _serial_merge(lambda q: sh[gs + q], width,
                           lambda q: sh[gs + width + q], width, i, d - i, ITEMS)
        width *= 2
    return it.reshape(-1)[:cnt]


def _group_model(row, L, w, rng=None, drop_tail=False):
    """Launches 1-6 on one row -> (order: the position at each index of the
    order, -1 in the gap between the two ranges; first: the indices of each
    group's first rank; grouped: the positions placed). drop_tail: the tail
    positions p > L - 4 left out of the table as if they were singletons
    (not the kernel: it shows why they stay)."""
    order_of = rng.permutation if rng is not None else np.arange
    words = _words(row, L)
    s = 2 * w
    # count: the positions whose 16 key bytes are zero stay out of the table
    zero = (words[0] == 0) & (words[1] == 0) & (words[2] == 0) & (words[3] == 0)
    ins = order_of(L)
    if drop_tail:
        ins = ins[ins + 4 <= L]
        zero &= np.arange(L) + 4 <= L
    ins = ins[~zero[ins]]
    slot, rank, cnt = _count_model(words[0], s, ins)
    grouped = np.zeros(L, bool)
    grouped[ins] = cnt[slot[ins]] >= 2
    # the zero group (k_zero): its zero positions in position order, then
    # the others of w0 = 0, its slot cleared for alloc
    zpos = np.flatnonzero(zero)
    z, zslot, others, zoff = len(zpos), -1, 0, 0
    small = large = tiles = 0
    entries, cross = [], {}
    if z:
        km = ins[words[0][ins] == 0]
        if len(km):
            zslot = int(slot[km[0]])
            others = int(cnt[zslot])
            cnt[zslot] = 0
        g = z + others
        grouped[zpos] = g >= 2
        grouped[km] = g >= 2
        if 2 <= g <= CAP:
            zoff, small = 0, g
            if (g - 1) // CAP:
                cross[(g - 1) // CAP] = (0, g)
        elif g > CAP:
            large = g
            zoff = w - g
            if others:
                entries.append((0, zoff + z, others, z))
                tiles = -(-others // CAP)
    # alloc: the slots in order (or shuffled)
    off = np.zeros(s, np.int64)
    for q in order_of(s):
        g = int(cnt[q])
        if 2 <= g <= CAP:
            off[q] = small
            if (small + g - 1) // CAP != small // CAP:
                cross[(small + g - 1) // CAP] = (small, small + g)
            small += g
        elif g > CAP:
            large += g
            off[q] = w - large
            entries.append((tiles, w - large, g, 0))
            tiles += -(-g // CAP)
    # scatter: keys by their rank in a lexsort of (w1, w2, w3, p)
    krank = np.empty(L, np.int64)
    krank[np.lexsort((np.arange(L), words[3], words[2], words[1]))] = np.arange(L)
    pos_of = np.argsort(krank)
    bufs = [np.full(w, -1, np.int64), np.full(w, -1, np.int64)]  # order, spare
    first = np.zeros(w, bool)
    zrank = np.zeros(L, np.int64)
    zrank[zpos] = np.arange(z)
    for p in np.flatnonzero(grouped):
        if zero[p]:
            at, b, f = zoff + zrank[p], 0, zrank[p] == 0
        elif zslot >= 0 and slot[p] == zslot:
            at, f = zoff + z + rank[p], False
            b = passes_of(others) & 1 if z + others > CAP else 0
        else:
            g = int(cnt[slot[p]])
            at, f = off[slot[p]] + rank[p], rank[p] == 0
            b = passes_of(g) & 1 if g > CAP else 0
        bufs[b][at] = krank[p]
        first[at] = f
    # sort: the small range's tiles (keys: segment, then krank) ...
    o = bufs[0]
    for t0 in range(0, small, CAP):
        c = min(CAP, small - t0)
        seg = np.cumsum(first[t0:t0 + c])
        k = _tile_sort(seg * (L + 1) + o[t0:t0 + c])
        sseg, o[t0:t0 + c] = k // (L + 1), k % (L + 1)
        first[t0:t0 + c] = sseg != np.concatenate([[0], sseg[:-1]])
    # ... and each large group's
    for _, base, g, _ in entries:
        b = bufs[passes_of(g) & 1]
        for k0 in range(0, g, CAP):
            c = min(CAP, g - k0)
            b[base + k0:base + k0 + c] = _tile_sort(b[base + k0:base + k0 + c])
    # fix: each crossing small group's two pieces
    for bnd, (s0, e0) in cross.items():
        o[s0:e0] = _merge(o[s0:bnd * CAP], o[bnd * CAP:e0], ITEMS, SORT_THREADS)
    # merge passes inside the large groups; each one's last lands in o
    width, q = CAP, 0
    while width < w:
        for _, base, g, _ in entries:
            if g <= width:
                continue
            src, dst = (bufs[(passes_of(g) - q) & 1],
                        bufs[(passes_of(g) - q - 1) & 1])
            for c0 in range(0, g, MCHUNK):
                gs = c0 // (2 * width) * (2 * width)
                a_len = min(width, g - gs)
                b_len = max(0, min(2 * width, g - gs) - width)
                d0, d1 = c0 - gs, min(c0 + MCHUNK, g) - gs

                def ka(i, gs=gs, src=src, base=base):
                    return src[base + gs + i]

                def kb(i, gs=gs, src=src, base=base):
                    return src[base + gs + width + i]
                i0 = _warp_merge_path(ka, a_len, kb, b_len, d0)
                i1 = _warp_merge_path(ka, a_len, kb, b_len, d1)
                dst[base + c0:base + gs + d1] = _merge(
                    ka(np.arange(i0, i1)), kb(np.arange(d0 - i0, d1 - i1)),
                    M_ITEMS, M_THREADS)
        width, q = 2 * width, q + 1
    order = np.where(o >= 0, pos_of[np.maximum(o, 0)], -1)
    return order, first, grouped


def _mix(a, b):
    h = (a * 0x9E3779B1 + b * 0x85EBCA77) & 0xFFFFFFFF
    return ((h ^ (h >> 15)) * 0x27D4EB2F) & 0xFFFFFFFF


def _ladder_model(row, L, w, tiles=None):
    """Launch 8: rec[p] = the seven ext_p << 16 | ref_p of p < L in the
    given 4,096-position tiles (default: all); zero elsewhere."""
    rec = np.zeros((w, 7), np.uint64)
    for t0 in range(0, L, LADDER_TILE):
        if tiles is not None and t0 // LADDER_TILE not in tiles:
            continue
        cnt = min(LADDER_TILE, L - t0)
        h = np.zeros(LADDER_SPAN, np.uint64)
        m = min(LADDER_SPAN, L - t0)
        h[:m] = row[t0:t0 + m]
        i = np.arange(cnt)
        for s in range(11):
            nxt = np.zeros(LADDER_SPAN, np.uint64)
            nxt[:LADDER_SPAN - (1 << s)] = h[1 << s:]
            h = _mix(h, nxt)
            p1 = s + 1
            if p1 >= 5:
                rec[t0 + i, p1 - 5] |= (h[i + (1 << p1)] & 0xFFFF) << 16
            if 5 <= p1 + 1 <= 11:
                rec[t0 + i, p1 + 1 - 5] |= h[i + (1 << (p1 + 1))] & 0xFFFF
    return rec


def _ladder_lcp(rec, L, a, b):
    """The ladder's lcp of position pairs (a, b) equal on 32 bytes."""
    lad = np.full(len(a), 32)
    alive = np.ones(len(a), bool)
    x = rec[a] ^ rec[b]
    for q in range(7):
        p = 5 + q
        e = (x[:, q] >> 16) == 0
        r = (x[:, q] & 0xFFFF) == 0
        lad = np.where(alive, np.where(e, 1 << (p + 1),
                                       lad + np.where(r, 1 << (p - 1), 0)),
                       lad)
        alive &= e
    return np.minimum(np.minimum(lad, LCP_CAP), np.maximum(L - np.maximum(a, b), 0))


LADDER = -1     # al: the ladder decides


def _al_model(row, L, order, first):
    """Launch 7: al at each index of the order (0 at a group's first
    rank), LADDER where 32 bytes are equal past L - max(a, b) > 32; and
    the flagged ladder tiles."""
    w = len(order)
    al = np.zeros(w, np.int64)
    i = np.flatnonzero((order >= 0) & ~first)
    a, b = order[i - 1], order[i]
    pad = np.zeros(w + 32, np.uint8)
    pad[:L] = row[:L]
    ne = pad[a[:, None] + np.arange(32)] != pad[b[:, None] + np.arange(32)]
    assert not ne[:, :4].any()          # one group: w0 equal
    f = np.where(ne.any(1), ne.argmax(1), -1)
    room = np.maximum(L - np.maximum(a, b), 0)
    al[i] = np.where(f >= 0, np.minimum(f, room),
                     np.where(room <= 32, room, LADDER))
    lad = i[al[i] == LADDER]
    tiles = set((order[lad] // LADDER_TILE).tolist()) | set(
        (order[lad - 1] // LADDER_TILE).tolist())
    return al, tiles


def _pick_model(L, order, al, rec):
    """Launch 9: each ranked position's candidate, packed lcp << 16 | (p -
    cand) at p (0: none; -7 where no rank is)."""
    w = len(order)
    res = np.full(w, -7, np.int64)
    lad = np.flatnonzero(al == LADDER)
    al = al.copy()
    if len(lad):
        al[lad] = _ladder_lcp(rec, L, order[lad - 1], order[lad])
    for k0 in range(0, w, PICK):
        kk = k0 - 4 + np.arange(PICK + 6)
        ps = np.where((kk >= 0) & (kk < w), order[np.clip(kk, 0, w - 1)], -1)
        ka = k0 - 3 + np.arange(PICK + 5)
        als = np.where((ka >= 0) & (ka < w), al[np.clip(ka, 0, w - 1)], 0)
        t = np.arange(PICK)
        real = (k0 + t < w) & (ps[t + 4] >= 0)
        p = ps[t + 4]
        bl = np.zeros(PICK, np.int64)
        bc = np.full(PICK, -1, np.int64)
        ln = np.full(PICK, 1 << 30)
        for d in range(1, 7):
            if d <= 4:
                ln = np.minimum(ln, als[t + 4 - d])
                c = ps[t + 4 - d]
            else:
                if d == 5:
                    ln = np.full(PICK, 1 << 30)
                ln = np.minimum(ln, als[t + d - 1])
                c = ps[t + d]
            better = (real & (c >= 0) & (c < p) & (p - c <= MAX_DISTANCE)
                      & (c + 4 <= L) & (ln >= 4) & (ln > bl))
            bl = np.where(better, ln, bl)
            bc = np.where(better, c, bc)
        res[p[real]] = np.where(bc >= 0, bl << 16 | (p - bc), 0)[real]
    return res


def _out_model(ranked, res):
    """Launch 10: (lcp, cand) of each position from the pick's result, or
    (0, -1) where the scatter found no rank."""
    v = np.where(ranked, res, 0)
    assert (v >= 0).all()
    return v >> 16, np.where(v > 0, np.arange(len(res)) - (v & 0xFFFF), -1)


def k_model(rows: np.ndarray, lens: np.ndarray, rng=None, drop_tail=False):
    """Kernel K on rows uint8 [n, W] and lens [n] -> lcp, cand [n, W]."""
    n, w = rows.shape
    lcp = np.empty((n, w), np.int64)
    cand = np.empty((n, w), np.int64)
    for r in range(n):
        L = int(min(max(lens[r], 0), w))
        order, first, grouped = _group_model(rows[r], L, w, rng, drop_tail)
        al, tiles = _al_model(rows[r], L, order, first)
        rec = _ladder_model(rows[r], L, w, tiles)
        res = _pick_model(L, order, al, rec)
        ranked = np.zeros(w, bool)        # the scatter's flags in lcp
        ranked[:L] = grouped
        assert ((res != -7) == ranked).all()
        lcp[r], cand[r] = _out_model(ranked, res)
    return lcp, cand


# ------------------------------------------------------------- the cases

def _rng(seed):
    return np.random.default_rng(seed)


def _ladder_pairs():
    """Copies equal for 32 to 4,200 bytes, then one byte off: the ladder
    decides their lcp (past LCP_CAP: the cap)."""
    rng = _rng(41)
    out = b""
    for n in (33, 40, 63, 64, 65, 100, 127, 128, 129, 300, 513, 1025, 2047,
              2048, 2049, 3000, 4095, 4096, 4097, 4200):
        blk = rng.integers(0, 256, n + 8, np.uint8).tobytes()
        twin = bytearray(blk)
        twin[n] ^= 0x5A
        out += blk + rng.integers(0, 256, 50, np.uint8).tobytes() + bytes(twin)
    return out


def _distance_edges():
    """A 64-byte key, then its copy 65,535 back and 65,536 back (a farther
    copy 5,000 more)."""
    rng = _rng(7)
    out = b""
    for dist in (65535, 65536):
        head = rng.integers(0, 256, 64, np.uint8).tobytes()
        noise = rng.integers(0, 256, 5000 + dist, np.uint8).tobytes()
        out += (head + noise[:4936] + head + noise[4936:4872 + dist] + head
                + b"end")
    return out


def _data(what):
    text = corpus_file("fields.c")
    table = {
        "grammar.lsp": lambda: corpus_file("grammar.lsp"),
        "kennedy.xls slice": lambda: corpus_file("kennedy.xls")[200_000:240_000],
        "alice29.txt slice": lambda: corpus_file("alice29.txt")[:30_000],
        "70,000 zeros": lambda: bytes(70_000),
        "random": lambda: _rng(61).integers(0, 256, 20_000, np.uint8).tobytes(),
        "ladder pairs": _ladder_pairs,
        "distance edges": _distance_edges,
        "runs and text": lambda: b"".join(text[k * 700:(k + 1) * 700]
                                          + bytes([k]) * r for k, r in
                                          enumerate((5000, 33, 4097, 64, 300))),
        "superblock": lambda: b"".join(corpus_file(nm) for nm in CANTERBURY)[:1 << 14],
        "ptt5 slice": lambda: corpus_file("ptt5")[:150_000],
    }
    return table[what]() if what in table else edge(what)


# name -> (data, seg_log2)
CASES = {
    "grammar.lsp (W = n = 3,721)": ("grammar.lsp", 17),
    "kennedy.xls slice at seg_log2 12 (a partial last row)":
        ("kennedy.xls slice", 12),
    "alice29.txt slice at seg_log2 7": ("alice29.txt slice", 7),
    "70,000 zeros (W = n)": ("70,000 zeros", 17),
    "random bytes at seg_log2 13 (a partial last row)": ("random", 13),
    "ladder pairs (W = n)": ("ladder pairs", 17),
    "distance edges 65,535 and 65,536 (W = 2^17)": ("distance edges", 17),
    "runs and text at seg_log2 14": ("runs and text", 14),
    "a 2^14 CT-SB superblock": ("superblock", 17),
    "a tail position between two copies (W = n = 43)": ("tail barrier", 17),
    f"one group of CAP - 1 = {CAP - 1} (W = n)": (f"group of {CAP - 1}", 17),
    f"one group of CAP = {CAP} (W = n)": (f"group of {CAP}", 17),
    f"one group of CAP + 1 = {CAP + 1} (W = n)": (f"group of {CAP + 1}", 17),
    "singletons only (W = n = 20,000)": ("singletons", 17),
    "every group tied on 16 bytes (W = n = 10,000)": ("ties on 16", 17),
    "keys of one home slot (W = n = 4,096)": ("collisions", 17),
    "ptt5's first 150,000 bytes at seg_log2 17": ("ptt5 slice", 17),
}


def _rows(data, seg_log2):
    x = torch.from_numpy(np.frombuffer(bytes(data), np.uint8).copy())
    return lz_ops.segment_rows(x, seg_log2)


def _check(data, seg_log2, rng=None):
    rows, lens = _rows(data, seg_log2)
    lcp, cand = k_model(rows.numpy(), lens.numpy(), rng)
    pl, pc = lz_ops.match_table(rows, lens)
    assert np.array_equal(lcp, pl.numpy())
    assert np.array_equal(cand, pc.numpy())
    s = rows.shape[1]
    for r in range(rows.shape[0]):
        seg = np.frombuffer(bytes(data), np.uint8)[r * s:(r + 1) * s]
        ol, oc = slz4_ref.match_table_v2(seg)
        assert np.array_equal(lcp[r, :len(seg)], ol)
        assert np.array_equal(cand[r, :len(seg)], oc)
    return lcp, cand


@pytest.mark.parametrize("name", list(CASES))
def test_model_equals_match_table_and_the_oracle(name):
    what, sl = CASES[name]
    _check(_data(what), sl)


@pytest.mark.parametrize("name", ["grammar.lsp (W = n = 3,721)",
                                  "70,000 zeros (W = n)",
                                  "runs and text at seg_log2 14",
                                  "keys of one home slot (W = n = 4,096)",
                                  f"one group of CAP + 1 = {CAP + 1} (W = n)"])
def test_model_in_any_order_the_atomics_take(name):
    """The table's slots, the ranks in a group and the groups' places in
    the order as any run of the kernel's atomics may take them (shuffled):
    the same table."""
    what, sl = CASES[name]
    _check(_data(what), sl, rng=_rng(len(name)))


def test_tail_positions_must_stay_in_their_groups():
    """The model with the tail positions p > L - 4 left out of the table
    (as singletons) differs from the oracle on TAIL_BARRIER; the kernel's
    model, which keeps them, does not (test above)."""
    rows, lens = _rows(TAIL_BARRIER, 17)
    ol, oc = slz4_ref.match_table_v2(np.frombuffer(TAIL_BARRIER, np.uint8))
    lcp, cand = k_model(rows.numpy(), lens.numpy())
    assert np.array_equal(cand[0], oc) and np.array_equal(lcp[0], ol)
    lcp, cand = k_model(rows.numpy(), lens.numpy(), drop_tail=True)
    assert not np.array_equal(cand[0], oc)
    p = TAIL_BARRIER.index(b"ab\x00\x00\x00\x07")
    assert oc[p] == -1 and cand[0, p] == TAIL_BARRIER.index(b"ab\x00")


def test_edge_cases_have_their_shape():
    """The edges are what they say: one group of exactly m positions at
    the CAP edges (the small range's last size, and the least large one);
    no key twice in the singletons' row (its tail too); the tied row's
    groups equal on 16 bytes beside their tail; the colliding keys share a
    home slot, and the table probes past it."""
    for m in (CAP - 1, CAP, CAP + 1):
        w0 = _words(np.frombuffer(group_of(m), np.uint8), 8 * m)[0]
        assert np.count_nonzero(w0 == 0x01020304) == m
    for what, want in (("singletons", 1), ("ties on 16", 250)):
        data = np.frombuffer(edge(what), np.uint8)
        words = _words(data, len(data))
        _, cnt = np.unique(words[0], return_counts=True)
        assert cnt.max() == want
    words = _words(np.frombuffer(edge("ties on 16"), np.uint8), 10_000)
    keys = np.stack(words, 1)[:9_960]
    assert len(np.unique(keys, axis=0)) == 40
    keys = colliding_keys(4096)
    assert len(set(home_slot(keys, 8192).tolist())) == 1 and len(keys) == 8
    w0 = _words(np.frombuffer(collisions(), np.uint8), 4096)[0]
    slot, _, cnt = _count_model(w0, 8192, np.arange(4096))
    got = {int(k): int(s) for k, s in zip(w0, slot) if int(k) in keys}
    assert sorted(got) == sorted(keys) and len(set(got.values())) == 8
    assert home_slot(keys, 8192)[0] in got.values()
    assert all(cnt[s] == 4 for s in got.values())


def test_model_zero_group_cases_are_reached():
    """The zero group (positions whose 16 key bytes are zero, first in
    their group and in position order) in each of its forms: large with
    others of w0 = 0 to sort (ptt5), large with none (zeros), small (the
    tail barrier's one zero position beside its others)."""
    for what, big, with_others in (("ptt5 slice", True, True),
                                   ("70,000 zeros", True, False),
                                   ("tail barrier", False, True)):
        rows, lens = _rows(_data(what), 17)
        L = int(lens[0])
        words = _words(rows.numpy()[0], L)
        zero = (words[0] == 0) & (words[1] == 0) & (words[2] == 0) & (words[3] == 0)
        others = int(np.count_nonzero((words[0] == 0) & ~zero))
        assert zero.any() and (zero.sum() + others > CAP) == big, what
        assert (others > 0) == with_others, what


def test_model_ladder_and_cap_cases_are_reached():
    """The ladder pairs give lengths past 32 bytes that only the ladder
    gives, up to LCP_CAP, and the distance edges a candidate 65,535 back
    and none 65,536 back."""
    lcp, cand = _check(_data("ladder pairs"), 17)
    assert (lcp > 32).any() and (lcp == LCP_CAP).any()
    assert len(set(lcp[lcp > 32].tolist())) > 5
    data = _data("distance edges")
    lcp, cand = _check(data, 17)
    d = np.arange(cand.shape[1]) - cand[0]
    assert (d[cand[0] >= 0] == MAX_DISTANCE).any()
    assert not (d[cand[0] >= 0] > MAX_DISTANCE).any()


def test_model_builds_the_ladder_only_where_it_is_read():
    """al leaves a pair to the ladder only where 32 bytes are equal with
    more than 32 left: kennedy.xls's slice flags no tile, the ladder pairs
    and the zeros some; a ladder record read by the pick lies in a flagged
    tile."""
    for what, sl, some in (("kennedy.xls slice", 17, False),
                           ("ladder pairs", 17, True),
                           ("70,000 zeros", 17, True)):
        rows, lens = _rows(_data(what), sl)
        row, L, w = rows.numpy()[0], int(lens[0]), rows.shape[1]
        order, first, _ = _group_model(row, L, w)
        al, tiles = _al_model(row, L, order, first)
        assert bool(tiles) == some, what
        lad = np.flatnonzero(al == LADDER)
        assert set((order[lad] // LADDER_TILE).tolist()) <= tiles


@pytest.mark.parametrize("w", list(range(1, 129)))
def test_model_narrow_rows(w):
    """W = 1..128: one row of n = W bytes, and rows of W = 2^k (k <= 7)
    over a text of 300 bytes with a partial last row."""
    text = corpus_file("fields.c")
    _check(text[3 * w:4 * w], 17)
    if w & (w - 1) == 0:
        _check(text[:300], w.bit_length() - 1)


@pytest.mark.parametrize("w", [2047, 2049, 6149, 8199, CAP - 1, CAP + 1,
                               3 * CAP + 5])
def test_model_w_not_a_power_of_two(w):
    """W = n around 2,048 and around the tile size: partial tiles, small
    groups across tile boundaries."""
    _check((corpus_file("asyoulik.txt") * 2)[:w], 20)


def test_model_zero_rows_and_short_lens():
    """Rows whose lens cut them anywhere (zero past each), and a row of
    zeros: every key ties on its bytes."""
    rng = _rng(5)
    w = 3000
    rows = np.zeros((4, w), np.uint8)
    lens = np.array([w, 1500, 3, 2999])
    for r in range(3):
        rows[r, :lens[r]] = rng.integers(0, 4, lens[r])
    lcp, cand = k_model(rows, lens)
    pl, pc = lz_ops.match_table(torch.from_numpy(rows), torch.from_numpy(lens))
    assert np.array_equal(lcp, pl.numpy()) and np.array_equal(cand, pc.numpy())
    past = np.arange(w)[None] + 4 > lens[:, None]
    assert (cand[past] == -1).all() and (lcp[past] == 0).all()


def test_ladder_model_equals_the_operands():
    """Launch 8's tiled records equal lz_ops.operands' ladder words."""
    data = _data("runs and text")[:9000]
    rows, lens = _rows(data, 17)
    rec = _ladder_model(rows.numpy()[0], int(lens[0]), rows.shape[1])
    _, ladder = lz_ops.operands(rows)
    for q, lad in enumerate(ladder):
        assert np.array_equal(rec[:, q].astype(np.int64), lad[0].numpy())


def test_match_v2_wrapper():
    """On a CPU tensor the wrapper runs the plain version (no launch
    counted); it checks its inputs as Z's wrapper does."""
    rows, lens = _rows(corpus_file("grammar.lsp"), 9)
    before = lz_kernels.match_v2_launches
    for a, b in zip(lz_kernels.match_v2(rows, lens),
                    lz_ops.match_table(rows, lens)):
        assert torch.equal(a, b)
    assert lz_kernels.match_v2_launches == before
    with pytest.raises(ValueError, match="uint8"):
        lz_kernels.match_v2(rows.to(torch.int32), lens)
    with pytest.raises(ValueError, match="lens"):
        lz_kernels.match_v2(rows, lens[:1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        lz_kernels.match_v2(rows.t(), lens)
    with pytest.raises(ValueError, match="int64"):
        lz_kernels.match_v2(rows, lens.to(torch.int32))
    blob = lz_ops.slz4_encode(corpus_file("grammar.lsp"), device="cpu")
    assert blob == slz4_ref.slz4_encode(corpus_file("grammar.lsp"),
                                        parse="v2")
    assert lz_kernels.match_v2_launches == before


def test_match_v2_scratch():
    """The wrapper's scratch covers the kernel's layout at every width: the
    order, the merge buffer, the table and the (slot, rank) pairs (14 u32 a
    position) and the rows' counters, lists and flags."""
    for n, w in ((1, 1), (3, 17), (8, 1 << 17), (1, CAP + 1), (2, 6000), (1, (1 << 30))):
        nt, nl, nc = -(-w // CAP), -(-w // LADDER_TILE), -(-w // 2048)
        meta = (8 + 6 * nt + nl + nc + 3) & ~3
        assert lz_kernels.match_v2_scratch(n, w) >= 14 * n * w + n * meta
