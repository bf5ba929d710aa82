"""The arithmetic of kernel F (csrc/rans_encode.cu), written out in numpy:
the quotient st / f from a multiply-high by floor((2^32 - 1) / f) and one
correction, and the step built on it, held against integer division and
against the plain step (the rANS encoder of the JAX package's oracle and of
rans_ops.encode_events_plain) for every frequency 1..2^14 at the edge
states, and on random pairs."""

import numpy as np
import pytest

ANS_PROB_BITS = 14
ANS_TOTAL = 1 << ANS_PROB_BITS
U32 = (1 << 32) - 1


def rcp_np(f):
    """The per-symbol reciprocal of kernel F's table: floor((2^32-1) / f)."""
    return np.uint64(U32) // f


def quotient_np(s, f):
    """-> (q, corrections): q0 = the high word of s * rcp, then +1 while
    the remainder is >= f (the kernel takes one, unconditionally
    bounded by its argument; here they are counted)."""
    q = (s * rcp_np(f)) >> np.uint64(32)
    corr = np.zeros_like(q)
    while True:
        more = s - q * f >= f
        if not more.any():
            return q, corr
        q += more
        corr += more


def encode_step_np(st, f, c):
    """encode_step: -> (event, new state), u32 arithmetic as the kernel
    does it (the fused form s + c + q0*g + (r0 >= f ? g : 0))."""
    top = ((f << np.uint64(18)) - np.uint64(1)) & np.uint64(U32)
    emit = st > top
    e = np.where(emit, np.uint64(0x10000), np.uint64(0)) | (st & np.uint64(0xFFFF))
    s = np.where(emit, st >> np.uint64(16), st)
    q0 = (s * rcp_np(f)) >> np.uint64(32)
    r0 = s - q0 * f
    g = np.uint64(ANS_TOTAL) - f
    new = (s + c + q0 * g + np.where(r0 >= f, g, np.uint64(0))) & np.uint64(U32)
    return e, new


def plain_step(st, f, c):
    """The step as the plain version and the oracle write it."""
    emit = (st >> np.uint64(18)) >= f
    e = np.where(emit, np.uint64(0x10000), np.uint64(0)) | (st & np.uint64(0xFFFF))
    s = np.where(emit, st >> np.uint64(16), st)
    return e, ((s // f) << np.uint64(ANS_PROB_BITS)) | (s % f + c)


def _edge_states():
    """(s, f) for every f in 1..2^14: k*f - 1 and k*f across the range of
    the quotient, the top of the legal range (f << 18) - 1, and 0, 1,
    2^16 - 1, 2^16, 2^32 - 1 (the kernel's argument covers every u32; at
    f = 2^14, which never emits, every u32 is a legal state)."""
    f = np.arange(1, ANS_TOTAL + 1, dtype=np.uint64)
    cols = []
    for k in (1, 2, 3, 255, 256, 257, 1 << 12, (1 << 16) - 1, 1 << 16,
              (1 << 17) + 1, (1 << 18) - 1, 1 << 18):
        kf = np.uint64(k) * f
        cols += [kf - np.uint64(1), kf]
    cols.append((f << np.uint64(18)) - np.uint64(1))
    for v in (0, 1, (1 << 16) - 1, 1 << 16, U32):
        cols.append(np.full_like(f, v))
    s = np.stack(cols, axis=1)
    ff = np.broadcast_to(f[:, None], s.shape)
    keep = s <= U32
    return s[keep], ff[keep]


def test_quotient_is_exact_with_one_correction_at_most():
    s, f = _edge_states()
    assert len(np.unique(f)) == ANS_TOTAL
    q, corr = quotient_np(s, f)
    assert np.array_equal(q, s // f)
    assert corr.max() == 1          # never two: the kernel takes one
    assert corr.sum() > 0           # and it is needed (f = 1, k*f - 1, ...)


def test_quotient_on_random_pairs():
    rng = np.random.default_rng(5)
    f = rng.integers(1, ANS_TOTAL + 1, 500_000, dtype=np.uint64)
    top = np.minimum(f << np.uint64(18), np.uint64(1 << 32))
    s = (rng.random(500_000) * top.astype(np.float64)).astype(np.uint64)
    s = np.minimum(s, top - np.uint64(1))
    q, corr = quotient_np(s, f)
    assert np.array_equal(q, s // f) and corr.max() <= 1


@pytest.mark.parametrize("seed", [0, 1])
def test_step_matches_plain_for_every_frequency(seed):
    """The kernel's fused step equals the plain one on every f, with c
    from 0 to 2^14 - f, on the states a step sees: [2^16, 2^32), the
    emit threshold f << 18 and the value below it."""
    rng = np.random.default_rng(seed)
    f = np.arange(1, ANS_TOTAL + 1, dtype=np.uint64)
    c = (rng.random(ANS_TOTAL) * (np.uint64(ANS_TOTAL) - f + np.uint64(1))
         .astype(np.float64)).astype(np.uint64)
    c = np.minimum(c, np.uint64(ANS_TOTAL) - f)
    thr = f << np.uint64(18)
    cols = [thr - np.uint64(1), thr, np.full_like(f, 1 << 16),
            np.full_like(f, U32)]
    cols += list(rng.integers(1 << 16, 1 << 32, (8, ANS_TOTAL),
                              dtype=np.uint64))
    st = np.stack(cols, axis=1)
    ff = np.broadcast_to(f[:, None], st.shape)
    cc = np.broadcast_to(c[:, None], st.shape)
    keep = (st >= 1 << 16) & (st <= U32)
    st, ff, cc = st[keep], ff[keep], cc[keep]
    e_k, new_k = encode_step_np(st, ff, cc)
    e_p, new_p = plain_step(st, ff, cc)
    assert np.array_equal(e_k, e_p)
    assert np.array_equal(new_k, new_p)
    # a state leaves the step in [2^16, 2^32) again
    assert (new_k >= 1 << 16).all()
