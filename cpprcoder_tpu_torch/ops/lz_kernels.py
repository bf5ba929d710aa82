"""Kernel K, Z, P, Q and R wrappers: CT-LZ4 (SLZ4) v2 and v1 match tables,
parse walk, token serializer and decode on the card, each with its plain
PyTorch version beside it.

The JAX package has no Pallas kernel here. It runs these steps as XLA code
shaped by Mosaic's limits (cpprcoder_tpu/ops/lz_ops.py):
  - K replaces the v2 parse's match table, `_match_table_v2` (:589, with
    `_v2_operands` :540 and `_alcp_sorted` :557: one 16-operand stable
    lax.sort a segment, the pick in rank order, a sort back).
    `csrc/lz_match_v2.cu`, a memset and 11 + ceil(log2(W / 4,096))
    launches: the pick reads only the order inside each group of equal
    4-byte keys (w0), so each row's positions are grouped by w0 in a hash
    table in global memory (a 2,048-position tile's count of a key added
    at once by 64-bit atomics), each group of 2 or more gets a range of
    the order (the singletons none; the positions whose 16 key bytes are
    zero lead the group of w0 = 0 in position order, unsorted), a CTA
    sorts each 4,096-key tile of the small groups (a group a segment) or
    of a large group by (w1, w2, w3, p), the groups that cross a tile are
    merged in place, merge passes
    join each large group's tiles (the keys in global memory: no gather),
    the adjacent lcp is taken from the keys and the row, the hash ladder's
    records are built only for the 4,096-position tiles whose pairs are
    equal on 32 bytes, a CTA 256 ranks picks each rank's candidate into 4
    bytes at its position, and a last launch writes (lcp, cand) in
    position order. Bound: bytes, on Z's basis.
  - Z replaces the v1 parse's match table, `_candidates` (:81-100: one
    stable lax.sort of (flag, key, position) and the adjacent rank) and
    `_lcp_estimate` (:103-124: two u32 hash chains, descending spans, an
    estimate that the parse clamps after the walk). `csrc/lz_match.cu`, one
    launch: a CTA a tile of 4,096 positions of a segment stages the bytes
    from 65,535 before the tile to 4,096 past it in shared memory, keys the
    tile's exact 4-byte values in a shared hash set, scans the window before
    the tile once for each key's last position there (atomicMax), sorts the
    tile's (slot, position) pairs for the nearest earlier one inside it,
    and compares the bytes for the exact lcp once a chain (positions whose
    candidates move with them share their first mismatch), a warp 32
    positions at a time. Bound: bytes (the rows in, lcp and cand int64
    out: 17 bytes a position).
  - P replaces the walk's inputs (:700-709), `_greedy_membership`
    (:644-692: jump tables built from one-hot MXU dots, one lax.scan over
    128-position blocks) and the sort that lists the walk's matches
    (:730-742). `csrc/lz_encode.cu`, two launches and no host read: over
    the whole card, the walk's inputs from the match table and each
    position's exit from its block (blocks of 2^lb positions, pointer
    jumping in shared memory), into a scratch row of 2.5 bytes a
    position; then a CTA a segment stages the exits in shared memory (up
    to 2^17 positions), one thread hops the blocks' entries, each thread
    walks its block once from its entry and stages its matches, and after
    a scan the warps write them 32 at a time; the CTA zeroes the rows past
    the count. Bound: bytes (lcp and cand where the walk goes, the outputs
    whole); what holds it back is thread 0's hop chain and each block's
    walk, in one CTA a segment (walk_geometry).
  - Q replaces the byte-exact clamp (:716-728) and `_serialize_fn_v2`
    (:396-500). `csrc/lz_encode.cu`, two launches and no host read: a CTA
    a segment clamps every match (its share of the row's positions each
    thread, the first mismatch by atomicMin), sizes the tokens and scans
    them; then a CTA a 4,096-byte chunk of a segment's block finds its
    base from the blocks' sizes and writes the bytes, and the payload past
    the total is zeroed. The payload has the worst-case length
    `payload_bound(W)` a segment.
  - R replaces the decode's `_walk_v2_fn` and `_resolve_v2_fn`
    (:756-866). `csrc/lz_decode.cu`: each position's next token start over
    the whole card, then a CTA a segment finds the token starts in
    parallel (block exits, one thread's hops, a re-walk that writes the
    token table and each token's first failing check); then launches as
    wide as the output give each byte its token, resolve literal bytes,
    point match bytes back by the mod-hop and follow the pointers in place
    until every byte reaches a literal (`decode_geometry`'s rounds).

On a CPU tensor a wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cpprcoder_tpu_torch.native import build
from cpprcoder_tpu_torch.ops import lz_ops
from cpprcoder_tpu_torch.reference.slz4_ref import MIN_MATCH

match_v2_launches = 0    # kernel K
match_launches = 0       # kernel Z
walk_launches = 0        # kernel P
serialize_launches = 0   # kernel Q
decode_launches = 0      # kernel R

# R's error codes, a segment each (0: decoded)
ERRORS = {1: "offset 0", 2: "offset before the segment's start",
          3: "read past the segment's payload",
          4: "write past the segment's length",
          5: "decoded length differs from the segment's"}
OFFSET_ZERO, OFFSET_BEFORE, READ_OVERRUN, WRITE_OVERRUN, BAD_LENGTH = 1, 2, 3, 4, 5
HOPS = 7   # pointer hops a byte takes in one of R's rounds


def token_cap(width: int) -> int:
    """Matches a segment of `width` positions can hold: each covers at
    least MIN_MATCH of them."""
    return width // MIN_MATCH + 1


def _check(name: str, t: torch.Tensor, dtype, dim: int) -> None:
    if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype} of {dim} dims, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")


def _same_device(dev, **ts) -> None:
    for nm, t in ts.items():
        if t.device != dev:
            raise ValueError(f"{nm} is on {t.device}, not {dev}")


# ------------------------------------------------- K and Z: the match tables

def _check_table_inputs(rows: torch.Tensor, lens: torch.Tensor) -> None:
    _check("rows", rows, torch.uint8, 2)
    _check("lens", lens, torch.int64, 1)
    _same_device(rows.device, lens=lens)
    n, w = rows.shape
    if lens.numel() != n:
        raise ValueError(f"lens {tuple(lens.shape)} does not match rows "
                         f"{(n, w)}")
    if not 0 < w <= 1 << 30 or not 0 < n < 1 << 31:
        raise ValueError(f"{n} segments of width {w}: the kernels take "
                         f"1 to 2^31 - 1 segments of 1 to 2^30 positions")


def match_v2_scratch(n: int, w: int) -> int:
    """K's scratch in u32 words for n rows of w: 14 a position (the order
    and the merge buffer, 16 bytes each; the hash table, 2w slots of 8
    bytes; each position's slot and rank, 8 bytes: the ladder records reuse
    the buffer and the table, al and the pick's results the slot and rank)
    and 16 + 7 * ceil(w / 2,048) a row (its counters, the zero group, the
    large groups' list, the crossing groups, the ladder's tile flags, the
    count tiles' zero positions; csrc/lz_match_v2.cu `meta_words`)."""
    return 14 * n * w + n * (16 + 7 * -(-w // 2048))


def match_v2(rows: torch.Tensor, lens: torch.Tensor):
    """rows uint8 [n, W] (segment i's L_i = lens[i] bytes, zero past them)
    and lens int64 [n] -> lcp, cand int64 [n, W]: the v2 match table,
    lz_ops.match_table's. On the card: kernel K's launches, no host read,
    its scratch (match_v2_scratch, 56 bytes a position) from torch.empty."""
    global match_v2_launches
    _check_table_inputs(rows, lens)
    if rows.device.type == "cpu":
        return lz_ops.match_table(rows, lens)
    n, w = rows.shape
    dev = rows.device
    lib = build.load()
    with torch.cuda.device(dev):
        lcp, cand = torch.empty((2, n, w), dtype=torch.int64,
                                device=dev).unbind(0)
        scratch = torch.empty(match_v2_scratch(n, w), dtype=torch.int32,
                              device=dev)
        rc = lib.ct_lz_match_v2(rows.data_ptr(), lens.data_ptr(),
                                lcp.data_ptr(), cand.data_ptr(),
                                scratch.data_ptr(), n, w,
                                torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "ct_lz_match_v2")
    match_v2_launches += 1
    return lcp, cand


def match_v1(rows: torch.Tensor, lens: torch.Tensor):
    """rows uint8 [n, W] (segment i's L_i = lens[i] bytes, zero past them)
    and lens int64 [n] -> lcp, cand int64 [n, W]: the v1 match table,
    lz_ops.match_table_v1's. On the card: one launch, no host read."""
    global match_launches
    _check_table_inputs(rows, lens)
    if rows.device.type == "cpu":
        return lz_ops.match_table_v1(rows, lens)
    n, w = rows.shape
    dev = rows.device
    lib = build.load()
    with torch.cuda.device(dev):
        lcp, cand = torch.empty((2, n, w), dtype=torch.int64,
                                device=dev).unbind(0)
        rc = lib.ct_lz_match_v1(rows.data_ptr(), lens.data_ptr(),
                                lcp.data_ptr(), cand.data_ptr(), n, w,
                                torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "ct_lz_match_v1")
    match_launches += 1
    return lcp, cand


# ------------------------------------------------------------- P: the walk

WALK_MIN_LB, WALK_MAX_LB = 4, 12   # blocks of 16 to 4,096 positions
WALK_STAGED_W = 1 << 17            # the widest segment staged in shared memory
WALK_THREADS = 1024                # the most threads of a segment's CTA
STEP_TILE = 4096                   # positions of launch 1's CTA


class WalkGeometry(NamedTuple):
    lb: int          # blocks of 2^lb positions
    blocks: int      # blocks a segment
    threads: int     # launch 2's CTA
    per_thread: int  # blocks a thread (1 where staged)
    staged: bool     # exits, steps and matches in shared memory
    row_bytes: int   # launch 1's scratch a segment


def walk_geometry(width: int) -> WalkGeometry:
    """Kernel P's geometry for segments of `width` positions: blocks of
    2^lb positions, lb in [4, 12], weighing the hop chains (W / 2^lb hops
    of ~80 cycles) against each thread's walk of its block. Staged (up to
    2^17 positions: the hops in shared memory, in up to 8 regions side by
    side), lb is the least with 4^lb >= W / 8 (2^7 at 2^17: 1,024 blocks);
    above (each hop a global load, one chain), the least with 4^lb >= 2W.
    The scratch row: the exits' low bytes and high nibbles, then the step
    bytes (each part 16-byte aligned). Staged, launch 2 runs 1,024 threads
    and holds the exits, then the step bytes (blocks 2^lb + 4 apart) and
    2^lb / 4 + 1 u16 match slots a block; else up to 1,024 threads,
    several blocks each where there are more."""
    staged = width <= WALK_STAGED_W
    lb = WALK_MIN_LB
    while lb < WALK_MAX_LB and (4 ** lb * 8 < width if staged
                                else 4 ** lb < 2 * width):
        lb += 1
    nb = -(-width // (1 << lb))
    threads = WALK_THREADS if staged else min(WALK_THREADS, -(-nb // 32) * 32)
    w16 = -(-width // 16) * 16
    h16 = -(-((width + 1) // 2) // 16) * 16
    return WalkGeometry(lb, nb, threads, -(-nb // threads), staged,
                        2 * w16 + h16)


def _walk_steps_plain(step: torch.Tensor, off: torch.Tensor):
    """The walk over given inputs (step >= 1, p + step[p] <= W; off the
    match's distance where step > 1). From position 0 of each segment the
    walk goes to p + step[p]; a position with step > 1 is a match.
    Vectorised across segments: an iteration moves every segment to its
    next match (the first position at or after it with step > 1, from a
    reverse cummin) and past it. -> mpos, mlen, moff int32 [n,
    token_cap(W)] (the walk's matches in order, their step and offset; zero
    past the count) and count int32 [n]."""
    n, w = step.shape
    dev = step.device
    tcap = token_cap(w)
    pos = torch.arange(w, device=dev)
    nxt = torch.where(step > 1, pos, w).flip(1).cummin(1).values.flip(1)
    nxt = torch.cat([nxt, torch.full((n, 1), w, device=dev)], 1)
    mpos, mlen, moff = (torch.zeros((n, tcap), dtype=torch.int32, device=dev)
                        for _ in range(3))
    count = torch.zeros(n, dtype=torch.int64, device=dev)
    cur = torch.zeros(n, dtype=torch.int64, device=dev)
    rows = torch.arange(n, device=dev)
    while True:
        q = nxt.gather(1, cur[:, None])[:, 0]
        act = q < w
        if not bool(act.any()):
            break
        r, qa, c = rows[act], q[act], count[act]
        st = step[r, qa]
        mpos[r, c] = qa.to(torch.int32)
        mlen[r, c] = st
        moff[r, c] = off[r, qa]
        count += act
        cur = torch.where(act, q + step.gather(1, q.clamp(max=w - 1)[:, None])
                          [:, 0], w)
    return mpos, mlen, moff, count.to(torch.int32)


def walk_plain(lcp: torch.Tensor, cand: torch.Tensor, lens: torch.Tensor,
               lazy: bool = True):
    """Plain version of kernel P: lz_ops.walk_inputs, then
    _walk_steps_plain. -> mpos, mlen, moff int32 [n, token_cap(W)] (the
    walk's matches in order: position, unclamped length, offset; zero past
    the count) and count int32 [n]."""
    return _walk_steps_plain(*lz_ops.walk_inputs(lcp, cand, lens, lazy))


def walk(lcp: torch.Tensor, cand: torch.Tensor, lens: torch.Tensor,
         lazy: bool = True):
    """lcp, cand int64 [n, W] (a match table, lz_ops.match_table's or
    match_v1's: lcp <= LCP_CAP, cand -1 or an earlier position at most
    MAX_DISTANCE back) and lens int64 [n] -> walk_plain's outputs.
    On the card: two launches (the walk's inputs and the blocks' exits
    over the whole card, then a CTA a segment), no host read."""
    global walk_launches
    _check("lcp", lcp, torch.int64, 2)
    _check("cand", cand, torch.int64, 2)
    _check("lens", lens, torch.int64, 1)
    _same_device(lcp.device, cand=cand, lens=lens)
    n, w = lcp.shape
    if cand.shape != lcp.shape or lens.numel() != n:
        raise ValueError(f"cand {tuple(cand.shape)} and lens "
                         f"{tuple(lens.shape)} do not match lcp {(n, w)}")
    if not 0 < w <= 1 << 30 or not 0 < n < 1 << 31:
        raise ValueError(f"{n} segments of width {w}: the kernels take "
                         f"1 to 2^31 - 1 segments of 1 to 2^30 positions")
    if lcp.device.type == "cpu":
        return walk_plain(lcp, cand, lens, lazy)
    dev = lcp.device
    tcap = token_cap(w)
    geo = walk_geometry(w)
    lib = build.load()
    with torch.cuda.device(dev):
        # two allocations: the scratch rows with the entries behind them,
        # and the outputs with the counts behind them
        planes = torch.empty(n * geo.row_bytes + (0 if geo.staged else
                                                  4 * n * geo.blocks),
                             dtype=torch.uint8, device=dev)
        out = torch.empty(3 * n * tcap + n, dtype=torch.int32, device=dev)
        mpos, mlen, moff = out[:3 * n * tcap].view(3, n, tcap).unbind(0)
        count = out[3 * n * tcap:]
        rc = lib.ct_lz_walk(lcp.data_ptr(), cand.data_ptr(), lens.data_ptr(),
                            planes.data_ptr(),
                            planes.data_ptr() + n * geo.row_bytes,
                            mpos.data_ptr(), mlen.data_ptr(), moff.data_ptr(),
                            count.data_ptr(), n, w, geo.lb, int(lazy), tcap,
                            torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "ct_lz_walk")
    walk_launches += 1
    return mpos, mlen, moff, count


# ------------------------------------------------------- Q: the serializer

def _ext_len(v: torch.Tensor) -> torch.Tensor:
    """LZ4's extension bytes for a length field of v (15 and more)."""
    return torch.where(v >= 15, (v - 15) // 255 + 1, 0)


def payload_bound(width: int) -> int:
    """Bytes the serializer can write for a segment of at most `width`
    bytes: width + width // 255 + 16.

    Proof. Let ext(v) = (v - 15) // 255 + 1 for v >= 15, else 0: the 255-run
    bytes of a length field v. A segment of L <= width bytes is tokens t,
    each of ll_t literals and a match of m_t >= MIN_MATCH bytes, and one
    last token of literals, with sum(ll_t + m_t) = L. (Kernel P's matches
    are at least MIN_MATCH long and their first min(length, 32) bytes
    compare exactly, by the v2 spec's words, or all of them, by the v1
    spec's exact lcp, so the clamp keeps m_t >= MIN_MATCH.) A match token
    writes 1 + ext(ll) + ll + 2 + ext(m - 4) bytes for its ll + m output
    bytes: an excess of 3 + ext(ll) + ext(m - 4) - m, which is at most
    ext(ll) - 1, since ext(m - 4) = 0 for m < 19 (and m >= 4), and ext(m -
    4) <= (m - 4 + 240) / 255 <= m - 4 for m >= 19. And ext(ll) - 1 <= (ll
    - 15) // 255 <= ll // 255 for ll >= 15 (-1 below). The last token
    writes 1 + ext(ll) + ll: an excess of at most 2 + ll // 255. The
    excesses sum to at most 2 + sum(ll // 255) <= 2 + L // 255, so a
    segment's block has at most L + L // 255 + 2 bytes; the bound rounds
    the 2 up to 16."""
    return width + width // 255 + 16


def serialize_plain(rows, lens, mpos, mlen, moff, count):
    """Plain version of kernel Q: slz4_ref.serialize_tokens from tensors.
    Each match is clamped at its first mismatch; token t's literals start
    at match t - 1's clamped end, and a last token holds the literals up
    to the segment's length. -> payload uint8 [n * payload_bound(W)] (the
    segments' blocks in order from byte 0, zero past them), sizes int64
    [n]: the caller keeps payload[:sizes.sum()]."""
    n, w = rows.shape
    dev = rows.device
    tcap = mpos.shape[1]
    cnt = count.to(torch.int64)
    flat = rows.reshape(-1)
    real = torch.arange(tcap, device=dev)[None, :] < cnt[:, None]
    seg_r = torch.arange(n, device=dev)[:, None].expand(n, tcap)[real]
    pos_r, len_r, off_r = (t[real].to(torch.int64) for t in (mpos, mlen, moff))
    # the clamp: the first byte of each match that differs from its source
    tok = torch.repeat_interleave(torch.arange(len_r.numel(), device=dev),
                                  len_r)
    j = torch.arange(tok.numel(), device=dev) - (len_r.cumsum(0) - len_r)[tok]
    a = seg_r[tok] * w + pos_r[tok] + j
    neq = flat[a] != flat[a - off_r[tok]]
    clamped = len_r.scatter_reduce(0, tok, torch.where(neq, j, len_r[tok]),
                                   "amin")

    def full(v):
        out = torch.zeros((n, tcap + 1), dtype=torch.int64, device=dev)
        out[:, :tcap][real] = v
        return out

    mp, mc, mo = full(pos_r), full(clamped), full(off_r)
    tix = torch.arange(tcap + 1, device=dev)[None, :]
    final = tix == cnt[:, None]
    active = tix <= cnt[:, None]
    lit_start = torch.cat([torch.zeros((n, 1), dtype=torch.int64, device=dev),
                           (mp + mc)[:, :-1]], 1)
    lit_len = torch.where(final, lens.to(torch.int64)[:, None], mp) - lit_start
    m = torch.where(final, 0, mc)
    off = torch.where(final, 0, mo)
    el = _ext_len(lit_len)
    em = torch.where(m > 0, _ext_len(m - MIN_MATCH), 0)
    size = torch.where(active, 1 + el + lit_len
                       + torch.where(m > 0, 2 + em, 0), 0)
    sizes = size.sum(1)
    seg = torch.arange(n, device=dev)[:, None].expand(n, tcap + 1)[active]
    ls, ll, m, off, el, size = (t[active] for t in (lit_start, lit_len, m, off,
                                                    el, size))
    start = size.cumsum(0) - size
    # every payload byte from its token's fields
    tb = torch.repeat_interleave(torch.arange(size.numel(), device=dev), size)
    u = torch.arange(tb.numel(), device=dev) - start[tb]
    ll, m, off, el = ll[tb], m[tb], off[tb], el[tb]
    mx = (m - MIN_MATCH).clamp(min=0)
    head = (ll.clamp(max=15) << 4) | torch.where(m > 0, mx.clamp(max=15), 0)
    lrem = ll - 15
    lext = torch.where(u - 1 < lrem // 255, 255, lrem % 255)
    lit = flat[(seg[tb] * w + ls[tb] + u - 1 - el).clamp(0, n * w - 1)]
    o = u - 1 - el - ll
    mrem = mx - 15
    mext = torch.where(o - 2 < mrem // 255, 255, mrem % 255)
    val = torch.where(
        u == 0, head, torch.where(
            u < 1 + el, lext, torch.where(
                u < 1 + el + ll, lit.to(torch.int64), torch.where(
                    o == 0, off & 0xFF, torch.where(o == 1, off >> 8, mext)))))
    payload = torch.zeros(n * payload_bound(w), dtype=torch.uint8, device=dev)
    payload[:val.numel()] = val
    return payload, sizes


def serialize(rows, lens, mpos, mlen, moff, count):
    """rows uint8 [n, W] (segment i's L_i = lens[i] bytes, zero past them),
    lens int64 [n], and kernel P's outputs -> serialize_plain's outputs.
    On the card: two launches and no host read."""
    global serialize_launches
    _check("rows", rows, torch.uint8, 2)
    _check("lens", lens, torch.int64, 1)
    for nm, t in (("mpos", mpos), ("mlen", mlen), ("moff", moff)):
        _check(nm, t, torch.int32, 2)
    _check("count", count, torch.int32, 1)
    _same_device(rows.device, lens=lens, mpos=mpos, mlen=mlen, moff=moff,
                 count=count)
    n, w = rows.shape
    if tuple(mpos.shape) != (n, token_cap(w)) or mlen.shape != mpos.shape \
            or moff.shape != mpos.shape or count.numel() != n \
            or lens.numel() != n:
        raise ValueError("tokens do not match rows [n, W]")
    if rows.device.type == "cpu":
        return serialize_plain(rows, lens, mpos, mlen, moff, count)
    dev = rows.device
    tcap = mpos.shape[1]
    lib = build.load()
    with torch.cuda.device(dev):
        clamped, tstart = torch.empty(n * (2 * tcap + 1), dtype=torch.int32,
                                      device=dev).split([n * tcap,
                                                         n * (tcap + 1)])
        sizes = torch.empty(n, dtype=torch.int64, device=dev)
        payload = torch.empty(n * payload_bound(w), dtype=torch.uint8,
                              device=dev)
        rc = lib.ct_lz_serialize(
            rows.data_ptr(), lens.data_ptr(), mpos.data_ptr(), mlen.data_ptr(),
            moff.data_ptr(), count.data_ptr(), clamped.data_ptr(),
            tstart.data_ptr(), sizes.data_ptr(), payload.data_ptr(), n, w,
            tcap, torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "ct_lz_serialize")
    serialize_launches += 1
    return payload, sizes


# ------------------------------------------------------------ R: the decode

def _decode_segment(comp: bytes, payload, out, pos: int, size: int, d: int,
                    length: int) -> int:
    """One segment's LZ4 block comp[pos:pos + size] into out[d:d + length]
    (comp: the payload's bytes on the host, for the parse; the copies are
    tensor slices). -> 0 or an error code of ERRORS."""
    end, d0, dend = pos + size, d, d + length
    while pos < end:
        tok = comp[pos]
        pos += 1
        lit = tok >> 4
        if lit == 15:
            while True:
                if pos >= end:
                    return READ_OVERRUN
                lit += comp[pos]
                pos += 1
                if comp[pos - 1] != 255:
                    break
        if pos + lit > end:
            return READ_OVERRUN
        if d + lit > dend:
            return WRITE_OVERRUN
        out[d:d + lit] = payload[pos:pos + lit]
        pos += lit
        d += lit
        if pos >= end:
            break
        if pos + 2 > end:
            return READ_OVERRUN
        off = comp[pos] | comp[pos + 1] << 8
        pos += 2
        if off == 0:
            return OFFSET_ZERO
        mlen = (tok & 15) + MIN_MATCH
        if tok & 15 == 15:
            while True:
                if pos >= end:
                    return READ_OVERRUN
                mlen += comp[pos]
                pos += 1
                if comp[pos - 1] != 255:
                    break
        if d - off < d0:
            return OFFSET_BEFORE
        if d + mlen > dend:
            return WRITE_OVERRUN
        # the source repeats with period off: copy one period, then double
        k = min(off, mlen)
        out[d:d + k] = out[d - off:d - off + k]
        while k < mlen:
            c = min(k, mlen - k)
            out[d + k:d + k + c] = out[d:d + c]
            k += c
        d += mlen
    return 0 if d == dend else BAD_LENGTH


def decode_plain(payload, bases, sizes, n: int, s: int):
    """Plain version of kernel R: a token loop a segment, its literal runs
    and matches copied as tensor slices. -> out uint8 [n] (segment i at
    i * s, its min(s, n - i * s) bytes; all zero where the segment failed)
    and err int32 [n_segs] (ERRORS' codes)."""
    dev = payload.device
    comp = payload.cpu().numpy().tobytes()
    out = torch.zeros(n, dtype=torch.uint8, device=dev)
    err = []
    for i, (b, z) in enumerate(zip(bases.tolist(), sizes.tolist())):
        d, length = i * s, min(s, n - i * s)
        err.append(_decode_segment(comp, payload, out, b, z, d, length))
        if err[-1]:
            out[d:d + length] = 0
    return out, torch.tensor(err, dtype=torch.int32, device=dev)


def decode_geometry(n: int, s: int):
    """Kernel R's geometry for n bytes in segments of s -> (tcap, rounds).
    tcap = min(s, n) // 4 + 2 token entries a segment: every token but the
    last adds at least MIN_MATCH output bytes, so the first failing token,
    or the last one of a segment that decodes, has index <= len // 4 + 1.
    A match byte points into an earlier token's match or its own token's
    literals, so a chain of pointers has at most one hop a token with a
    match: at most min(s, n) // 4. Each round follows every pointer up to
    HOPS times, reading the pointers it meets as at least the round before
    left them, which multiplies every chain's reach by HOPS + 1: rounds is
    the least r >= 1 with (HOPS + 1)^r >= min(s, n) // 4."""
    tcap = min(s, n) // MIN_MATCH + 2
    rounds, reach = 1, HOPS + 1
    while reach < min(s, n) // MIN_MATCH:
        rounds += 1
        reach *= HOPS + 1
    return tcap, rounds


def decode_scratch(total: int, n_segs: int, n: int, s: int, device):
    """Kernel R's scratch for a payload of `total` bytes, in one int32
    allocation -> (nxt, exits, rec, ntok, src, pending): next() and the
    exits a payload byte, the token table [n_segs * tcap, 4], the token
    counts, the byte sources (n rounded up to 16) and the round flags; rec
    and src 16-byte aligned."""
    tcap, rounds = decode_geometry(n, s)
    parts = [4 * n_segs * tcap, -(-n // 16) * 16, max(total, 1), max(total, 1),
             n_segs, rounds + 1]
    rec, src, nxt, exits, ntok, pending = torch.empty(
        sum(parts), dtype=torch.int32, device=device).split(parts)
    return nxt, exits, rec, ntok, src, pending


def decode(payload, bases, sizes, n: int, s: int):
    """payload uint8 [total], bases and sizes int64 [n_segs] (segment i's
    block is payload[bases[i]:bases[i] + sizes[i]], inside the payload,
    the blocks apart from one another), n_segs == ceil(n / s) ->
    decode_plain's outputs. On the card: min(s, n) < 2^31 and a payload
    of fewer than 2^31 - 1 bytes; no host read."""
    global decode_launches
    _check("payload", payload, torch.uint8, 1)
    _check("bases", bases, torch.int64, 1)
    _check("sizes", sizes, torch.int64, 1)
    _same_device(payload.device, bases=bases, sizes=sizes)
    n_segs = bases.numel()
    if sizes.numel() != n_segs or n_segs != -(-n // s) or n < 1 \
            or n_segs >= 1 << 31:
        raise ValueError(f"{n_segs} segments do not cover n={n} at s={s}, "
                         f"or are 2^31 or more")
    if payload.device.type == "cpu":
        return decode_plain(payload, bases, sizes, n, s)
    if min(s, n) >= 1 << 31 or payload.numel() >= (1 << 31) - 1:
        raise ValueError(f"segments of {min(s, n)} bytes, a payload of "
                         f"{payload.numel()}: kernel R takes segments below "
                         f"2^31 bytes and a payload below 2^31 - 1")
    dev = payload.device
    tcap, rounds = decode_geometry(n, s)
    lib = build.load()
    with torch.cuda.device(dev):
        out = torch.empty(n, dtype=torch.uint8, device=dev)
        err = torch.empty(n_segs, dtype=torch.int32, device=dev)
        scratch = decode_scratch(payload.numel(), n_segs, n, s, dev)
        rc = lib.ct_lz_decode(payload.data_ptr(), bases.data_ptr(),
                              sizes.data_ptr(),
                              *(t.data_ptr() for t in scratch),
                              out.data_ptr(), err.data_ptr(), n_segs, n,
                              min(s, n), tcap, rounds, HOPS,
                              torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "ct_lz_decode")
    decode_launches += 1
    return out, err
