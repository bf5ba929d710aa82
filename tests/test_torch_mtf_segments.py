"""The segmented MTF and MTF-1 of kernels M and N (csrc/mtf.cu), as a numpy
model, held against the oracle (reference/mtf_ref.py) and the JAX package's
mtf_encode_jax / mtf_decode_jax, exactly (tolerance 0).

The kernels cut each 2^15-byte block into segments of L bytes and run the
segments side by side, each from the exact list it starts with. Moves
depend only on the rank and the previous rank, never on which byte sits at
a position, so:
  - decode runs each segment against placeholders 0..255 (its outputs are
    indices into the segment's unknown start list, its final placeholder
    list the permutation it applies) and composes the permutations in order;
  - encode builds each start list from the last step touching each byte
    before the segment (most recent first, untouched bytes in identity
    order; MTF-1's head first), with MTF-1's head and "previous rank was 0"
    from a three-register machine that also touches each head a swap
    pushes off.
The model follows the kernel's order of work: per-segment tables first,
then their running max, then the segments.
"""

from functools import lru_cache

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from cpprcoder_tpu.ops import mtf_ops as jmtf
from cpprcoder_tpu_torch.reference import bwt_ref, mtf_ref

BLOCK = mtf_ref.MTF_BLOCK


def run_list(start, values, prev, mtf1, decode):
    """One segment's steps from list `start` and previous rank `prev` ->
    (outputs, final list)."""
    lst = list(start)
    out = []
    for v in values:
        v = int(v)
        r = v if decode else lst.index(v)
        out.append(lst[r] if decode else r)
        if mtf1:
            mtf_ref._mtf1_update(lst, r, prev)
        elif r > 0:
            lst.insert(0, lst.pop(r))
        prev = r
    return out, lst


def head_step(state, b):
    """MTF-1's head machine, one byte: state (h, T0, pz) -> (state, the head
    a swap pushed off or None)."""
    h, t0, pz = state
    eq = b == h
    swap = not eq and b == t0 and not pz
    return (b if swap else h, t0 if eq else (h if swap else b), eq), \
        (h if swap else None)


def head_machine(block, seg_len):
    """The machine run straight through: (h, T0, pz) at each segment's
    start, and (step, byte) for each head a swap pushes off."""
    state, starts, demoted = (0, 1, False), [], []
    for i, b in enumerate(block):
        if i % seg_len == 0:
            starts.append(state)
        state, off = head_step(state, int(b))
        if off is not None:
            demoted.append((i, off))
    return starts, demoted


def head_machine_by_pairs(block, seg_len):
    """The kernel's way to the same start states: after a segment's first
    pair (b[p-1] == b[p] == a) and the byte c after it, the state is
    (a, c, 0) ((a, -, 1) if c == a) or (c, a, 0), whatever came before, and
    h tells which; each segment runs both from there on its own, and one
    walk over the segments runs only each one's bytes up to p + 1. Before
    the first pair (or to the end, without one) no step after the first
    non-swap swaps, so the walk runs that far, then the last two bytes
    before the pair (or the end); where the first step does not swap and
    that stretch is longer than 3, each segment has worked out the rest as
    a function of h alone (its tail), and the walk looks it up."""
    x = [int(b) for b in block]
    n, nseg = len(x), -(-len(block) // seg_len)
    pairs, ends, tails = [], [], []
    for j in range(nseg):
        s0, e = j * seg_len, min(n, (j + 1) * seg_len)
        p = next((q for q in range(s0 + 1, e) if x[q] == x[q - 1]), -1)
        pairs.append(p)
        cont = 0 <= p < e - 1
        if cont:
            a, c = x[p], x[p + 1]
            paths = [(a, c, c == a), (a, c, c == a) if c == a else (c, a, False)]
            for i in range(p + 2, e):
                paths = [head_step(st, x[i])[0] for st in paths]
            ends.append(paths)
        else:
            ends.append(None)
        # the tail: from the stretch's last two bytes on, the end state as
        # a function of h alone, for h each tail byte and (None) any other
        end = p if p >= 0 else e
        tail = {}
        for h in [x[i] for i in range(end - 2, p + 2 if cont else e)] + [None]:
            st = (h, h, True)
            for i in range(end - 2, p + 2 if cont else e):
                st = head_step(st, x[i])[0]
            if cont:
                st = ends[j][0 if st[0] == x[p] else 1]
            tail.setdefault(h, st)
        tails.append(tail if end - s0 > 3 else None)
    state, starts = (0, 1, False), []
    for j in range(nseg):
        starts.append(state)
        e, p, i = min(n, (j + 1) * seg_len), pairs[j], j * seg_len
        cont = 0 <= p < e - 1
        if cont and p - i <= 3:
            # an early pair: the second continuation exactly when step p - 1
            # codes a at a rank >= 1 without a swap and h == c
            for i in range(i, p - 1):
                state = head_step(state, x[i])[0]
            h, t0, pz = state
            a, c = x[p], x[p + 1]
            state = ends[j][1 if a != h and not (a == t0 and not pz)
                            and h == c else 0]
            continue
        b0 = x[i]
        if tails[j] is not None and not (b0 != state[0] and b0 == state[1]
                                         and not state[2]):
            # the first step does not swap, so h stays through the stretch
            h = state[0]
            st = tails[j].get(h, tails[j][None])
            state = tuple(h if v is None else v for v in st[:2]) + (st[2],)
            continue
        # no pair before `end`: after the first step that is not a swap, h
        # stays, and the last two bytes give T0 and pz
        end = p if p >= 0 else e
        while i < end:
            state, off = head_step(state, x[i])
            i += 1
            if off is None:
                break
        if end - i > 2:
            state, i = (state[0], state[0], True), end - 2
        for i in range(i, p + 2 if cont else e):
            state = head_step(state, x[i])[0]
        if cont:
            state = ends[j][0 if state[0] == x[p] else 1]
    demoted = []
    for j in range(nseg):   # each segment again, from its start state
        state = starts[j]
        for i in range(j * seg_len, min(n, (j + 1) * seg_len)):
            state, off = head_step(state, x[i])
            if off is not None:
                demoted.append((i, off))
    return starts, demoted


def start_lists(block, seg_len, mtf1):
    """-> (start list, prev) of each segment, from last touches."""
    nseg = -(-len(block) // seg_len)
    touch = [{} for _ in range(nseg)]   # per segment: byte -> last step + 1
    for i, b in enumerate(block):
        touch[i // seg_len][int(b)] = i + 1
    starts = [(0, 1, False)] * nseg
    if mtf1:
        starts, demoted = head_machine_by_pairs(block, seg_len)
        for i, b in demoted:
            t = touch[i // seg_len]
            t[b] = max(t.get(b, 0), i + 1)
    out, before = [], np.zeros(256, np.int64)
    c = np.arange(256)
    for j in range(nseg):
        key = (before << 8) | (255 - c)
        if mtf1:
            key[starts[j][0]] = 1 << 40
        prev = 0 if (mtf1 and starts[j][2]) else 1
        out.append(([int(x) for x in np.argsort(-key, kind="stable")], prev))
        for b, t in touch[j].items():
            before[b] = max(before[b], t)
    return out


def encode_block(block, seg_len, mtf1):
    out = []
    for j, (start, prev) in enumerate(start_lists(block, seg_len, mtf1)):
        out += run_list(start, block[j * seg_len:(j + 1) * seg_len], prev,
                        mtf1, False)[0]
    return np.array(out, np.uint8)


def decode_block(ranks, seg_len, mtf1):
    nseg = -(-len(ranks) // seg_len)
    idx, perm = [], []
    for j in range(nseg):
        prev = int(ranks[j * seg_len - 1]) if j else 1
        o, p = run_list(range(256), ranks[j * seg_len:(j + 1) * seg_len],
                        prev, mtf1, True)
        idx.append(o)
        perm.append(p)
    start = list(range(256))
    out = []
    for j in range(nseg):
        out += [start[k] for k in idx[j]]
        start = [start[k] for k in perm[j]]
    return np.array(out, np.uint8)


def model(data, seg_len, mtf1, decode):
    x = np.frombuffer(data, np.uint8)
    f = decode_block if decode else encode_block
    return b"".join(f(x[i:i + BLOCK], seg_len, mtf1).tobytes()
                    for i in range(0, len(x), BLOCK))


def _text(n, seed):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(1, 9), dtype=np.uint8))
             for _ in range(200)]
    return b" ".join(words[i] for i in rng.integers(0, 200, n // 2 + 8))[:n]


def _bwt(n):
    """The last columns of the BWT of a seeded text, 2^15 bytes a block."""
    x = np.frombuffer(_text(n, 11), np.uint8)
    return b"".join(bwt_ref.bwt_forward_block(x[i:i + BLOCK])[0].tobytes()
                    for i in range(0, n, BLOCK))


# under MTF-1, "aabb" then "ab"... makes every later step a swap (rank 1
# after a nonzero rank); "aab" then "ab"... makes every even step from 4 on
# rank 1 after rank 0 (no move): a segment's first byte at an even offset
# falls on one
CASES = {
    "bwt of a text": lambda n: _bwt(n),
    "one byte repeated": lambda n: b"\x07" * n,
    "swaps at segment starts": lambda n: (b"aabb" + b"ab" * n)[:n],
    "rank 1 after rank 0 at segment starts": lambda n: (b"aab" + b"ab" * n)[:n],
    "all 256 values at random": lambda n: np.random.default_rng(12).integers(
        0, 256, n, np.uint8).tobytes(),
}
SEG_LENS = [1, 32, 128, 1024]
# (case, n, L): each case across two blocks, and on the BWT output the
# lengths n = 1, L - 1, L + 1, 2^15 (a segment a byte: at most 4,099 bytes,
# to keep the model's lists small)
PARAMS = [(c, BLOCK + 1 if L > 1 else 4099, L) for c in CASES
          for L in SEG_LENS]
PARAMS += [("bwt of a text", n, L) for L in SEG_LENS
           for n in sorted({1, L - 1, L + 1, BLOCK if L > 1 else 4096} - {0})]


@lru_cache(maxsize=None)
def _reference(case, n, mtf1):
    """(data, ranks): the oracle's ranks, which the JAX package's equal."""
    data = CASES[case](n)
    blob = mtf_ref.mtf_encode(data, mtf1)
    assert jmtf.mtf_encode_jax(data, mtf1) == blob
    assert jmtf.mtf_decode_jax(blob) == data
    return data, blob[5:]


@pytest.mark.parametrize("mtf1", [False, True], ids=["mtf", "mtf1"])
@pytest.mark.parametrize("case,n,seg_len", PARAMS)
def test_segmented_model_matches_oracle_and_jax(case, n, seg_len, mtf1):
    data, ranks = _reference(case, n, mtf1)
    assert model(data, seg_len, mtf1, decode=False) == ranks
    assert model(ranks, seg_len, mtf1, decode=True) == data


def test_the_cases_reach_their_segment_edges():
    """The two run cases put what they are named for on the first byte of
    segments of every length tried (MTF-1 ranks from the oracle)."""
    for case, want in (("swaps at segment starts", True),
                       ("rank 1 after rank 0 at segment starts", False)):
        r = mtf_ref.mtf_encode_block(
            np.frombuffer(CASES[case](4200), np.uint8), True)
        for seg_len in SEG_LENS[1:]:
            for s in range(seg_len, 4200, seg_len):
                assert r[s] == 1 and (r[s - 1] != 0) == want


def test_the_head_machine_tracks_the_list():
    """Every 500 steps, the machine's h and pz against the oracle's list and
    previous rank, and the oracle's list rebuilt from h and the last
    touches."""
    x = np.frombuffer(_bwt(6000), np.uint8)
    demoted = dict(head_machine(x, len(x))[1])   # step -> the head pushed off
    lst, prev = list(range(256)), 1
    touched = {}
    for i, b in enumerate(x[:-1]):
        r = lst.index(int(b))
        mtf_ref._mtf1_update(lst, r, prev)
        prev = r
        touched[int(b)] = i + 1
        if i in demoted:
            touched[demoted[i]] = i + 1
        if i % 500 == 499:
            # the state after step i is the start of a segment at i + 1
            h, _, pz = head_machine(x[:i + 2], i + 1)[0][-1]
            assert h == lst[0] and pz == (prev == 0)
            rest = sorted((c for c in range(256) if c != lst[0]),
                          key=lambda c: (-touched.get(c, 0), c))
            assert [lst[0]] + rest == lst


@pytest.mark.parametrize("seg_len", SEG_LENS[1:])
@pytest.mark.parametrize("case", list(CASES))
def test_the_walk_over_pairs_equals_the_straight_machine(case, seg_len):
    """Start states (h and pz exactly; T0 too, but where pz is 1 and T0 is
    read by no step before it is overwritten) and pushed-off heads."""
    x = np.frombuffer(CASES[case](5000), np.uint8)
    want, want_off = head_machine(x, seg_len)
    got, got_off = head_machine_by_pairs(x, seg_len)
    assert got_off == want_off
    assert [(h, pz) for h, _, pz in got] == [(h, pz) for h, _, pz in want]
    assert [t for _, t, pz in got if not pz] == [t for _, t, pz in want
                                                 if not pz]


@settings(max_examples=60, deadline=None)
@given(st.binary(min_size=1, max_size=700), st.integers(1, 300),
       st.booleans())
def test_segmented_model_on_random_bytes(data, seg_len, mtf1):
    ranks = mtf_ref.mtf_encode(data, mtf1)[5:]
    assert model(data, seg_len, mtf1, decode=False) == ranks
    assert model(ranks, seg_len, mtf1, decode=True) == data


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 3), min_size=1, max_size=400),
       st.integers(1, 40))
def test_the_walk_on_few_byte_values(values, seg_len):
    """Pairs, ping-pong swaps and pair-free segments at every offset: the
    walk over pairs gives the straight machine's start states and
    pushed-off heads."""
    x = np.array(values, np.uint8)
    want, want_off = head_machine(x, seg_len)
    got, got_off = head_machine_by_pairs(x, seg_len)
    assert got_off == want_off
    assert [(h, pz) for h, _, pz in got] == [(h, pz) for h, _, pz in want]
    assert [t for _, t, pz in got if not pz] == [t for _, t, pz in want
                                                 if not pz]
