"""Kernel P, the CT-LZ4 v2 parse walk (csrc/lz_encode.cu), on the CPU: a
numpy model of its Hopper design held to a serial walk, to `walk_plain`
(whole arrays: the zeros past each count too), to the JAX package's
`_greedy_membership` visited mask and `_parse_fn_v2` matches (seg_log2 >=
7 and below its 2^18-token bound), and to the v2 oracle's tokens.

The model follows the kernel step for step: launch 1's walk inputs, step
bytes (255: a match of 256 or more, its length read again from lcp) and
exits by pointer jumping in tiles of 4,096 positions, each exit 12 bits
past its block's end (a low byte and a nibble); launch 2's hop chains over
blocks of 2^lb positions (a region of blocks a warp, each from the region's
first position, stitched to the walk's own chain by thread 0, which must
give the serial chain's entries), each thread's one walk of its block
(literal runs skipped four bytes a load) with its matches staged, the
scan, the writes and the zero fill; above 2^17 positions the global
branch (several blocks a thread, walked twice). Bytes of the scratch that launch 1 never writes
hold garbage here, as on the card. Change the model with the kernel."""

import numpy as np
import pytest
import torch

from conftest import CANTERBURY, corpus_file
from cpprcoder_tpu.ops import lz_ops as jlz
from cpprcoder_tpu_torch.ops import lz_kernels, lz_ops
from cpprcoder_tpu_torch.reference import slz4_ref

TILE = lz_kernels.STEP_TILE
HOP_REGIONS, HOP_MIN_BLOCKS = 8, 16   # csrc/lz_encode.cu
SMEM_MAX = 212 * 1024     # csrc/lz_encode.cu WALK_SMEM_MAX
GARBAGE = 0x5A            # scratch bytes launch 1 leaves unwritten
SENTINEL = -7             # output words the kernel has not written


def _rng(seed):
    return np.random.default_rng(seed)


def _runs_between_text():
    """Text with runs of 300 to 5,000 bytes between its pieces: matches of
    up to LCP_CAP that cross many blocks, exits far past a block's end."""
    text = corpus_file("fields.c")
    out = b""
    for k, n in enumerate((300, 700, 1500, 5000, 2600, 4097)):
        out += text[k * 1000:(k + 1) * 1000] + bytes([k + 1]) * n
    return out


def _synthetic(w, seed=5):
    """A match table of w positions that no data needs to back: candidates
    at 1% of positions with lcp 4 to 299, some 4,096 long."""
    rng = _rng(seed)
    pos = np.arange(w)
    lcp = rng.integers(0, 300, w)
    lcp[rng.random(w) < 0.0005] = slz4_ref.LCP_CAP
    cand = np.where(rng.random(w) < 0.01, pos - rng.integers(1, 65_536, w), -1)
    return (torch.from_numpy(lcp[None]), torch.from_numpy(np.maximum(cand, -1)
                                                         [None]),
            torch.tensor([w], dtype=torch.int64))


# name -> (bytes, seg_log2, lazy); "synthetic W": a match table alone
CASES = {
    "grammar.lsp": ("grammar.lsp", 17, True),
    "fields.c at seg_log2 7": ("fields.c", 7, True),
    "kennedy.xls": ("kennedy.xls", 17, True),
    "70,000 zeros": ("zeros", 17, True),
    "200,000 random bytes": ("random", 17, True),
    "1 byte": ("1 byte", 17, True),
    "13 bytes": ("13 bytes", 17, True),
    "a match of 600": ("match 600", 17, True),
    "runs between text": ("runs", 17, True),
    "lazy=False": ("fields.c", 12, False),
    "2^17 - 1 positions": ("2^17 - 1", 17, True),
    "a 2^14 CT-SB superblock": ("superblock", 17, True),
    "W = 2^18, global": ("kennedy 2^18", 18, True),
    "W = 1,029,744, global": ("kennedy.xls", 20, True),
    "synthetic W = 2^22 + 5,000, two blocks a thread": ("synthetic", None,
                                                         True),
}


def _bytes(what):
    text = corpus_file("fields.c")
    if "." in what:
        return corpus_file(what)
    return {"zeros": bytes(70_000),
            "random": _rng(61).integers(0, 256, 200_000, np.uint8).tobytes(),
            "1 byte": b"z", "13 bytes": b"q" * 13,
            "match 600": b"xyz0" + b"abcdefgh" * 75 + b"tail!",
            "runs": _runs_between_text(),
            "2^17 - 1": (text * 12)[:(1 << 17) - 1],
            "superblock": b"".join(corpus_file(nm) for nm in CANTERBURY)
            [:1 << 14],
            "kennedy 2^18": corpus_file("kennedy.xls")[:1 << 18]}[what]


def _inputs(name):
    """-> (data or None, seg_log2, lazy, lcp, cand, lens) for a CASES entry:
    the port's match table of the data's rows."""
    what, sl, lazy = CASES[name]
    if what == "synthetic":
        return (None, None, lazy, *_synthetic((1 << 22) + 5000))
    data = _bytes(what)
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    rows, lens = lz_ops.segment_rows(x, sl)
    return (data, sl, lazy, *lz_ops.match_table(rows, lens), lens)


# ------------------------------------------------------------ the model

def _launch1(lcp, cand, length, w, lb, lazy):
    """step_kernel on one segment -> (its scratch row, the most pointer
    jumping rounds a tile took). Tiles past the last position where a match
    may start are not written."""
    geo = lz_kernels.walk_geometry(w)
    w16 = -(-w // 16) * 16
    h16 = -(-((w + 1) // 2) // 16) * 16
    row = np.full(geo.row_bytes, GARBAGE, np.uint8)
    limit = max(0, min(w, length - slz4_ref.LAST_MATCH_GUARD + 1))
    pos = np.arange(w)
    m0 = np.minimum(lcp, length - slz4_ref.END_LITERALS - pos)
    v = ((cand >= 0) & (pos <= length - slz4_ref.LAST_MATCH_GUARD)
         & (m0 >= slz4_ref.MIN_MATCH))
    if lazy:
        v1 = np.append(v[1:], False)
        m1 = np.append(m0[1:], 0)
        v = v & ~(v1 & (m1 > m0))
    step = np.where(v, m0, 1)
    rounds = 0
    for a in range(0, w, TILE):
        if a >= limit:
            continue
        m = min(TILE, w - a)
        i = np.arange(m)
        row[w16 + h16 + a:w16 + h16 + a + m] = np.minimum(step[a:a + m] - 1,
                                                          255)
        hi = np.minimum(((i >> lb) + 1) << lb, m)
        e = i + step[a:a + m]
        r = 0
        while (e < hi).any():   # the kernel's rounds, in place, reach as far
            e = np.where(e < hi, e[np.minimum(e, m - 1)], e)
            r += 1
        rounds = max(rounds, r)
        ex = e - hi
        assert ex.min() >= 0 and ex.max() < 4096
        row[a:a + m] = ex & 255
        nib = ex >> 8
        pair = nib[0::2] | np.append(nib[1::2], np.zeros(m % 2, int)) << 4
        row[w16 + a // 2:w16 + a // 2 + len(pair)] = pair
    return row, rounds


def _word(b, q):
    return int.from_bytes(b[q:q + 4].tobytes(), "little")


def _next_match(sb, p, end):
    """next_match: the first q in [p, end) whose step byte is not 0, four
    bytes a load (the bytes at or past end are garbage or the next
    plane's)."""
    x = _word(sb, p & ~3) >> (8 * (p & 3))
    q = p
    while x == 0:
        q = (q | 3) + 1
        if q >= end:
            return end
        x = _word(sb, q)
    return min(q + ((x & -x).bit_length() - 1) // 8, end)


def _launch2(row, lcp, cand, length, w, lb, tcap):
    """walk_kernel on one segment -> (mpos, mlen, moff, count, the hops on
    the critical path (the longest region's chain and thread 0's stitches),
    visited mask, the most matches a thread staged)."""
    geo = lz_kernels.walk_geometry(w)
    assert geo.lb == lb
    w16 = -(-w // 16) * 16
    h16 = -(-((w + 1) // 2) // 16) * 16
    elo, ehi = row[:w16], row[w16:w16 + h16]
    sb = row[w16 + h16:]
    limit = max(0, min(w, length - slz4_ref.LAST_MATCH_GUARD + 1))
    mask = (1 << lb) - 1

    def hop(p):
        return (p | mask) + 1 + int(elo[p]) + (
            (int(ehi[p >> 1]) >> ((p & 1) << 2) & 15) << 8)

    # the serial chain, which the regions' chains, stitched, must give
    serial = np.full(geo.blocks, -1)
    p = 0
    while p < limit:
        serial[p >> lb] = p
        p = hop(p)
    # region r's chain from its first position, a warp each (region 0's
    # is the walk's own, into entry; the others' into spec)
    nb = geo.blocks
    regions = (max(1, min(HOP_REGIONS, nb // HOP_MIN_BLOCKS)) if geo.staged
               else 1)
    per = -(-nb // regions)
    entry, spec = np.full(nb, -1), np.full(nb, -1)
    reg_end, reg_hops = [], []
    for r in range(regions):
        e = entry if r == 0 else spec
        hi = min(min(r * per + per, nb) << lb, limit)
        p, h = (r * per) << lb, 0
        while p < hi:
            e[p >> lb] = p
            p, h = hop(p), h + 1
        reg_end.append(p)
        reg_hops.append(h)
    # thread 0: the walk hops on into each region until it lands on the
    # region's chain, whose entries from there on are its own
    p, stitch = reg_end[0], 0
    for r in range(1, regions):
        b1 = min(r * per + per, nb)
        hi = min(b1 << lb, limit)
        while p < hi:
            k = p >> lb
            if spec[k] == p:
                entry[k:b1] = spec[k:b1]
                p = reg_end[r]
                break
            entry[k] = p
            p, stitch = hop(p), stitch + 1
    assert np.array_equal(entry, serial)
    hops = max(reg_hops) + stitch
    visited = np.zeros(w, bool)
    past = p   # the walk's first position at or past limit, unless a
    #            thread's walk reaches limit

    def match_len(q):
        code = int(sb[q])
        return code + 1 if code != 255 else int(min(
            lcp[q], length - slz4_ref.END_LITERALS - q))

    staged, counts, most = [], [], 0
    capb = (1 << lb) // 4 + 1
    for t in range(geo.threads):
        b0 = t * geo.per_thread
        b1 = min(b0 + geo.per_thread, geo.blocks)
        starts = [int(entry[b]) for b in range(b0, b1) if entry[b] >= 0]
        end = min(b1 << lb, limit)
        got = []
        p = starts[0] if starts else end
        while p < end:
            q = _next_match(sb, p, end)
            visited[p:q] = True
            if q >= end:
                p = end
                break
            visited[q] = True
            got.append(q)
            p = q + match_len(q)
        if starts and end == limit:
            past = p
        if geo.staged:
            assert len(got) <= capb
        most = max(most, len(got))
        staged.append(got)
        counts.append(len(got))
    visited[past:] = True   # literals from there on
    total = sum(counts)
    out = np.full((3, tcap), SENTINEL, np.int64)
    k = 0
    for got in staged:   # the scan's order: thread by thread
        for q in got:
            out[:, k] = (q, match_len(q), q - int(cand[q]))
            k += 1
    out[:, total:] = 0   # zero_tail
    assert (out != SENTINEL).all(), "an output word was never written"
    return (*out, total, hops, visited, most)


def _model(lcp, cand, lens, lazy):
    """Kernel P's design over all segments -> (mpos, mlen, moff, count,
    visited [n, W]) and its counters."""
    lcp, cand, lens = (t.numpy() for t in (lcp, cand, lens))
    n, w = lcp.shape
    geo = lz_kernels.walk_geometry(w)
    tcap = lz_kernels.token_cap(w)
    outs = [np.zeros((n, tcap), np.int64) for _ in range(3)]
    count = np.zeros(n, np.int64)
    visited = np.zeros((n, w), bool)
    info = {"rounds": 0, "hops": 0, "most_staged": 0}
    for i in range(n):
        row, rounds = _launch1(lcp[i], cand[i], int(lens[i]), w, geo.lb, lazy)
        mp, ml, mo, c, hops, vis, most = _launch2(
            row, lcp[i], cand[i], int(lens[i]), w, geo.lb, tcap)
        for o, v in zip(outs, (mp, ml, mo)):
            o[i] = v
        count[i], visited[i] = c, vis
        info["rounds"] = max(info["rounds"], rounds)
        info["hops"] = max(info["hops"], hops)
        info["most_staged"] = max(info["most_staged"], most)
    return (*outs, count, visited), info


def _serial(lcp, cand, lens, lazy):
    """The walk one match at a time over walk_inputs' step and off ->
    [(positions, lengths, offsets)] a segment."""
    step, off = (t.numpy() for t in lz_ops.walk_inputs(lcp, cand, lens, lazy))
    out = []
    for st, of in zip(step, off):
        at = np.flatnonzero(st > 1)
        got, p, j = [], 0, 0
        while True:
            j = np.searchsorted(at, p, "left")
            if j == len(at):
                break
            q = int(at[j])
            got.append((q, int(st[q]), int(of[q])))
            p = q + int(st[q])
        out.append(got)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_model_equals_the_serial_walk_and_walk_plain(name):
    """The model's outputs are the serial walk's matches and walk_plain's
    whole arrays (zeros past the count); its counters keep the design's
    bounds: pointer jumping within lb rounds, at most a hop a block, each
    block's matches within its 2^lb / 4 + 1 staged slots, the staged
    layout within shared memory."""
    _, _, lazy, lcp, cand, lens = _inputs(name)
    (mpos, mlen, moff, count, _), info = _model(lcp, cand, lens, lazy)
    n, w = lcp.shape
    geo = lz_kernels.walk_geometry(w)
    assert info["rounds"] <= geo.lb and info["hops"] <= geo.blocks
    assert geo.staged == (w <= 1 << 17)
    if geo.staged:
        assert _smem(w) <= SMEM_MAX
    for i, got in enumerate(_serial(lcp, cand, lens, lazy)):
        c = int(count[i])
        assert c == len(got)
        assert list(zip(mpos[i, :c], mlen[i, :c], moff[i, :c])) == got
    plain = lz_kernels.walk_plain(lcp, cand, lens, lazy)
    for a, b in zip((mpos, mlen, moff, count), plain):
        assert np.array_equal(a, b.numpy().astype(np.int64))
    if name == "W = 1,029,744, global":
        assert not geo.staged and geo.lb == 11 and geo.blocks == 503
    if name == "synthetic W = 2^22 + 5,000, two blocks a thread":
        assert geo.per_thread == 2 and geo.threads == 1024


def _smem(w):
    """Launch 2's dynamic shared memory where staged (ct_lz_walk): the
    exits, or the padded step bytes and the match slots."""
    geo = lz_kernels.walk_geometry(w)
    w16 = -(-w // 16) * 16
    h16 = -(-((w + 1) // 2) // 16) * 16
    return max(w16 + h16, -(-geo.blocks * ((1 << geo.lb) + 4) // 16) * 16
               + 2 * geo.blocks * ((1 << geo.lb) // 4 + 1))


def _jax_ok(n, seg_log2):
    s = 1 << seg_log2
    return seg_log2 >= 7 and -(-n // s) * (s // 4 + 3) < 1 << 18


JAX_CASES = [nm for nm, (what, sl, _) in CASES.items()
             if sl is not None and _jax_ok(len(_bytes(what)), sl)]


@pytest.mark.parametrize("name", JAX_CASES)
def test_model_equals_the_jax_package(name):
    """Where the JAX package's v2 parse runs (seg_log2 >= 7, C2; below C1):
    its match table is the port's, its `_greedy_membership` over the port's
    walk inputs visits the model's positions, and `_parse_fn_v2` lists the
    model's matches and offsets, as many a segment."""
    import jax
    import jax.numpy as jnp

    data, sl, lazy, lcp, cand, lens = _inputs(name)
    n_segs, w = lcp.shape
    s = 1 << sl
    blocks = np.zeros((n_segs, s), np.uint8)
    blocks.reshape(-1)[:len(data)] = np.frombuffer(data, np.uint8)
    jlens = np.minimum(s, len(data) - np.arange(n_segs) * s).astype(np.int32)
    jl, jc = jax.jit(jlz._match_table_v2)(jnp.asarray(blocks),
                                         jnp.asarray(jlens))
    assert np.array_equal(np.asarray(jl)[:, :w], lcp.numpy())
    assert np.array_equal(np.asarray(jc)[:, :w], cand.numpy())
    (mpos, _, moff, count, visited), _ = _model(lcp, cand, lens, lazy)
    step = np.ones((n_segs, s), np.int32)
    step[:, :w] = lz_ops.walk_inputs(lcp, cand, lens, lazy)[0].numpy()
    nxt = np.minimum(np.arange(s) + step, s).astype(np.int32)
    jvis = np.asarray(jlz._greedy_membership(jnp.asarray(nxt), n_segs, s))
    assert np.array_equal(jvis[:, :w], visited) and jvis[:, w:].all()
    jpos, _, joff, _, jn = (np.asarray(t) for t in jlz._parse_fn_v2(
        n_segs, s, jlz._t_cap(s), lazy)(jnp.asarray(blocks),
                                         jnp.asarray(jlens)))
    assert np.array_equal(jn, count)
    for i in range(n_segs):
        c = int(count[i])
        assert np.array_equal(jpos[i, :c], mpos[i, :c])
        assert np.array_equal(joff[i, :c], moff[i, :c])


@pytest.mark.parametrize("name", CANTERBURY)
def test_walk_plain_equals_the_oracles_tokens(name):
    """walk_plain at its interface (the match table, lens, lazy) lists
    parse_segment_v2's matches (position, offset; its unclamped length at
    least the clamped one) a segment, on the 11 files."""
    data = corpus_file(name)
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    rows, lens = lz_ops.segment_rows(x, 17)
    lcp, cand = lz_ops.match_table(rows, lens)
    mpos, mlen, moff, count = lz_kernels.walk_plain(lcp, cand, lens)
    assert (mpos.shape[1] == lz_kernels.token_cap(rows.shape[1])
            and mpos.dtype == torch.int32)
    for i in range(rows.shape[0]):
        toks = slz4_ref.parse_segment_v2(
            np.frombuffer(data, np.uint8)[i << 17:(i + 1) << 17])[:-1]
        c = int(count[i])
        assert c == len(toks)
        assert mpos[i, :c].tolist() == [t[0] + t[1] for t in toks]
        assert moff[i, :c].tolist() == [t[3] for t in toks]
        assert all(m >= t[2] for m, t in zip(mlen[i, :c].tolist(), toks))
        assert not mpos[i, c:].any() and not mlen[i, c:].any()


def test_walk_geometry():
    """Staged (up to 2^17 positions) lb is the least in [4, 12] with 4^lb
    >= W / 8, a thread a block (1,024 threads) and the staged layout within
    shared memory; above, the least with 4^lb >= 2W, up to 1,024 threads
    and as many blocks a thread as that needs."""
    want = {1: (4, 1, 1024, 1, True), 128: (4, 8, 1024, 1, True),
            3721: (5, 117, 1024, 1, True), 1 << 14: (6, 256, 1024, 1, True),
            (1 << 17) - 1: (7, 1024, 1024, 1, True),
            1 << 17: (7, 1024, 1024, 1, True),
            (1 << 17) + 1: (10, 129, 160, 1, False),
            1 << 18: (10, 256, 256, 1, False),
            1 << 20: (11, 512, 512, 1, False),
            1 << 30: (12, 1 << 18, 1024, 256, False)}
    for w, (lb, nb, threads, per, staged) in want.items():
        geo = lz_kernels.walk_geometry(w)
        assert geo[:5] == (lb, nb, threads, per, staged)
        bound = w / 8 if staged else 2 * w
        assert 4 ** lb >= bound or lb == 12
        assert lb == 4 or 4 ** (lb - 1) < bound
        assert geo.row_bytes == 2 * (-(-w // 16) * 16) + -(-((w + 1) // 2)
                                                           // 16) * 16
    for w in list(range(1, 5000, 37)) + list(range(5000, (1 << 17) + 1,
                                                   997)) + [1 << 17]:
        geo = lz_kernels.walk_geometry(w)
        w16 = -(-w // 16) * 16
        h16 = -(-((w + 1) // 2) // 16) * 16
        capb = (1 << geo.lb) // 4 + 1
        padded = -(-geo.blocks * ((1 << geo.lb) + 4) // 16) * 16
        assert geo.staged and geo.per_thread == 1 and geo.blocks <= 1024
        assert _smem(w) == max(w16 + h16, padded + 2 * geo.blocks * capb)
        assert _smem(w) <= SMEM_MAX
    assert _smem(1 << 17) == 202_752
