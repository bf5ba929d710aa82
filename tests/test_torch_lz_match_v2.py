"""Kernel K, CT-LZ4's v2 match table (csrc/lz_match_v2.cu), on the CPU: a
numpy model of its Hopper design held to its plain version
(lz_ops.match_table, whole arrays) and to the oracle
(slz4_ref.match_table_v2, a segment at a time).

The model follows the kernel launch for launch: launch 1 sorts each tile
of TILE positions by its keys (the 16 bytes at p as big-endian words, zero
from L on, then p), each thread's ITEMS keys sorted, then the block's merge
rounds (a merge path search a thread, ITEMS keys merged serially);
launch 2 builds each 4,096-position tile's hashes H_1 .. H_11 in place over
LADDER_SPAN u32s (zero past L and past the span) and records ext_p << 16 |
ref_p; the merge passes find each CTA's cuts by the warp's 32-way search
and merge its TILE outputs as the tile rounds do; the pick stages the
positions of its PICK ranks with 4 before and 2 after, their adjacent lcp
(32 exact bytes, then the records) with 3 before and 2 after, picks and
stores at each rank's position, the positions past L (0, -1) by index.
Keys compare here by their rank in a lexsort of the same words, which
orders them as the kernel's comparison does. Change the model with the
kernel."""

import numpy as np
import pytest
import torch

from conftest import CANTERBURY, corpus_file
from cpprcoder_tpu_torch.ops import lz_kernels, lz_ops
from cpprcoder_tpu_torch.reference import slz4_ref
from cpprcoder_tpu_torch.reference.slz4_ref import LCP_CAP, MAX_DISTANCE

ITEMS, SORT_THREADS = 8, 256            # csrc/lz_match_v2.cu
TILE = ITEMS * SORT_THREADS
LADDER_TILE, LADDER_SPAN = 4096, 4096 + LCP_CAP
PICK = 256
BIG = np.iinfo(np.int64).max            # the key past every real one


# ------------------------------------------------------------ the model

def _key_ranks(row, L):
    """The rank of each position p < L among the row's keys: (w0, w1, w2,
    w3) the big-endian words of the 16 bytes at p, zero from L on, then
    p."""
    pad = np.zeros(L + 16, np.uint8)
    pad[:L] = row[:L]
    b = np.lib.stride_tricks.sliding_window_view(pad, 16)[:L].astype(np.uint32)
    words = [(b[:, 4 * k] << 24) | (b[:, 4 * k + 1] << 16)
             | (b[:, 4 * k + 2] << 8) | b[:, 4 * k + 3] for k in range(4)]
    order = np.lexsort((np.arange(L), words[3], words[2], words[1], words[0]))
    rank = np.empty(L, np.int64)
    rank[order] = np.arange(L)
    return rank


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


def _serial_merge(a, a_len, b, b_len, i, j):
    """ct::serial_merge for every thread: -> keys [threads, ITEMS]."""
    out = []
    for _ in range(ITEMS):
        jj, ii = np.minimum(j, max(b_len - 1, 0)), np.minimum(i, max(a_len - 1, 0))
        y = b(jj) if b_len else np.full_like(j, BIG)
        x = a(ii) if a_len else np.full_like(i, BIG)
        take_b = (j < b_len) & ((i >= a_len) | (y < x))
        out.append(np.where(take_b, y, x))
        j = j + take_b
        i = i + ~take_b
    return np.stack(out, 1)


def _block_sort(keys):
    """ct::block_sort over SORT_THREADS threads of ITEMS keys (blocked)."""
    it = np.sort(keys.reshape(SORT_THREADS, ITEMS), axis=1)
    t0 = ITEMS * np.arange(SORT_THREADS)
    width = ITEMS
    while width < TILE:
        sh = it.reshape(-1)
        gs = t0 & ~(2 * width - 1)
        d = t0 - gs
        i = _merge_path(lambda q: sh[gs + q], width,
                        lambda q: sh[gs + width + q], width, d)
        it = _serial_merge(lambda q: sh[gs + q], width,
                           lambda q: sh[gs + width + q], width, i, d - i)
        width *= 2
    return it.reshape(-1)


def _sort_model(row, L, w):
    """Launches 1 and 3: the rank order of the row's positions < L (its
    first L entries), as the tile sort and the merge passes leave it."""
    rank = _key_ranks(row, L)
    pos_of = np.argsort(rank)           # a key (its rank) -> its position
    src = np.full(w, -1, np.int64)      # positions; rank[p] compares them
    for t0 in range(0, L, TILE):
        cnt = min(TILE, L - t0)
        keys = np.full(TILE, BIG)
        keys[:cnt] = rank[t0:t0 + cnt]
        src[t0:t0 + cnt] = pos_of[_block_sort(keys)[:cnt]]
    width = TILE
    while width < w:
        dst = np.full(w, -1, np.int64)
        for c0 in range(0, L, TILE):
            gs = c0 // (2 * width) * (2 * width)
            a_len = min(width, L - gs)
            b_len = max(0, min(2 * width, L - gs) - width)
            d0, d1 = c0 - gs, min(c0 + TILE, L) - gs

            def ka(q, gs=gs):
                return rank[src[gs + q]]

            def kb(q, gs=gs):
                return rank[src[gs + width + q]]
            i0 = _warp_merge_path(ka, a_len, kb, b_len, d0)
            i1 = _warp_merge_path(ka, a_len, kb, b_len, d1)
            j0 = d0 - i0
            na, nb = i1 - i0, d1 - i1 - j0
            sh = np.concatenate([ka(np.arange(i0, i0 + na)),
                                 kb(np.arange(j0, j0 + nb))])
            cnt = na + nb
            d = np.minimum(ITEMS * np.arange(SORT_THREADS), cnt)
            i = _merge_path(lambda q: sh[q], na, lambda q: sh[na + q], nb, d)
            out = _serial_merge(lambda q: sh[q], na, lambda q: sh[na + q], nb,
                                i, d - i)
            at = d[:, None] + np.arange(ITEMS)
            ok = at < cnt
            dst[c0 + at[ok]] = pos_of[out[ok]]
        src = dst
        width *= 2
    return src


def _mix(a, b):
    h = (a * 0x9E3779B1 + b * 0x85EBCA77) & 0xFFFFFFFF
    return ((h ^ (h >> 15)) * 0x27D4EB2F) & 0xFFFFFFFF


def _ladder_model(row, L, w):
    """Launch 2: rec[p] = the seven ext_p << 16 | ref_p of p < L."""
    rec = np.zeros((w, 7), np.uint64)
    for t0 in range(0, L, LADDER_TILE):
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


def _pair_lcp(row, rec, L, a, b):
    """The v2 lcp of position pairs (a, b), arrays."""
    pad = np.zeros(len(row) + 32, np.uint8)
    pad[:L] = row[:L]
    ba = pad[a[:, None] + np.arange(32)]
    bb = pad[b[:, None] + np.arange(32)]
    ne = ba != bb
    l = np.where(ne.any(1), ne.argmax(1), -1)
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
    l = np.where(l < 0, np.minimum(lad, LCP_CAP), l)
    return np.minimum(l, np.maximum(L - np.maximum(a, b), 0))


def _pick_model(row, L, w, perm, rec):
    """Launch 4: (lcp, cand) of every position of the row."""
    lcp = np.full(w, -7, np.int64)      # unwritten
    cand = np.full(w, -7, np.int64)
    for k0 in range(0, w, PICK):
        kk = k0 - 4 + np.arange(PICK + 6)
        ps = np.where((kk >= 0) & (kk < L), perm[np.clip(kk, 0, w - 1)], -1)
        ka = k0 - 3 + np.arange(PICK + 5)
        al = np.zeros(PICK + 5, np.int64)
        ok = (ka >= 1) & (ka < L)
        if ok.any():
            e = np.flatnonzero(ok)
            al[e] = _pair_lcp(row, rec, L, ps[e], ps[e + 1])
        t = np.arange(PICK)
        k = k0 + t
        real = k < L
        p = np.where(real, ps[t + 4], -1)
        bl = np.zeros(PICK, np.int64)
        bc = np.full(PICK, -1, np.int64)
        ln = np.full(PICK, 1 << 30)
        for d in range(1, 7):
            if d <= 4:
                ln = np.minimum(ln, al[t + 4 - d])
                c = ps[t + 4 - d]
            else:
                if d == 5:
                    ln = np.full(PICK, 1 << 30)
                ln = np.minimum(ln, al[t + d - 1])
                c = ps[t + d]
            better = (real & (c >= 0) & (c < p) & (p - c <= MAX_DISTANCE)
                      & (c + 4 <= L) & (ln >= 4) & (ln > bl))
            bl = np.where(better, ln, bl)
            bc = np.where(better, c, bc)
        inw = k < w
        at = np.where(real, p, k)[inw]
        lcp[at] = bl[inw]
        cand[at] = bc[inw]
    return lcp, cand


def k_model(rows: np.ndarray, lens: np.ndarray):
    """Kernel K on rows uint8 [n, W] and lens [n] -> lcp, cand [n, W]."""
    n, w = rows.shape
    lcp = np.empty((n, w), np.int64)
    cand = np.empty((n, w), np.int64)
    for r in range(n):
        L = int(min(max(lens[r], 0), w))
        perm = _sort_model(rows[r], L, w)
        rec = _ladder_model(rows[r], L, w)
        lcp[r], cand[r] = _pick_model(rows[r], L, w, perm, rec)
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
    return {
        "grammar.lsp": corpus_file("grammar.lsp"),
        "kennedy.xls slice": corpus_file("kennedy.xls")[200_000:240_000],
        "alice29.txt slice": corpus_file("alice29.txt")[:30_000],
        "70,000 zeros": bytes(70_000),
        "random": _rng(61).integers(0, 256, 20_000, np.uint8).tobytes(),
        "ladder pairs": _ladder_pairs(),
        "distance edges": _distance_edges(),
        "runs and text": b"".join(text[k * 700:(k + 1) * 700]
                                  + bytes([k]) * r for k, r in
                                  enumerate((5000, 33, 4097, 64, 300))),
        "superblock": b"".join(corpus_file(nm) for nm in CANTERBURY)[:1 << 14],
    }[what]


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
}


def _rows(data, seg_log2):
    x = torch.from_numpy(np.frombuffer(bytes(data), np.uint8).copy())
    return lz_ops.segment_rows(x, seg_log2)


def _check(data, seg_log2):
    rows, lens = _rows(data, seg_log2)
    lcp, cand = k_model(rows.numpy(), lens.numpy())
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


@pytest.mark.parametrize("w", list(range(1, 129)))
def test_model_narrow_rows(w):
    """W = 1..128: one row of n = W bytes, and rows of W = 2^k (k <= 7)
    over a text of 300 bytes with a partial last row."""
    text = corpus_file("fields.c")
    _check(text[3 * w:4 * w], 17)
    if w & (w - 1) == 0:
        _check(text[:300], w.bit_length() - 1)


@pytest.mark.parametrize("w", [TILE - 1, TILE + 1, 3 * TILE + 5,
                               4 * TILE + 7])
def test_model_w_not_a_power_of_two(w):
    """W = n around the tile size: partial tiles, a merge of a short run."""
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
    """Launch 2's tiled records equal lz_ops.operands' ladder words."""
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
