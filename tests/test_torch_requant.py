"""The arithmetic of the redesigned range-coder kernels (C and E,
csrc/rc_decode.cuh; A and D, csrc/rc_encode.cuh; their shared requant in
csrc/rcx_model.cuh), written out in numpy and held against the JAX
package's model functions:

- the quantize division without a 64-bit divide (`ct::quant_div`) equals
  `c * 32512 // tot` for every c <= tot < 2^32 tried;
- a requant that leaves a row's total below climit is a fixed point: run
  again on the same counts it gives the same counts and the same table, so
  the kernel may skip a row that no lane touched since. A row left at or
  above climit is not, and the kernel redoes it. Held on the JAX package's
  `rescale_rows_jnp`/`quantize_rows_jnp` (CT-RCX) and `rescale_jnp`/
  `quantize_jnp` (CT-RCQ) and on the port's `model_tables`;
- requantizing only the rows that changed (`ct::requant_changed`, kernels
  A and C) gives, over a whole oracle run, the counts and tables that
  requantizing every row at every window gives;
- kernel D's two sub-histograms, folded into the counts before each
  requant, give the model that one histogram gives;
- the search over a cum row kept in tree order (kernel E) and the bounded
  binary search over a sorted row (kernel C) find the symbol and the two
  cum values that searchsorted finds."""

import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpprcoder_tpu.models import cxmodel as jcx
from cpprcoder_tpu.models import qmodel as jq
from cpprcoder_tpu_torch.models import cxmodel as tcx

BASE = jcx.QTOTAL - jcx.QRESERVE      # 32512


def quant_div_np(c, tot):
    """ct::quant_div: scale = RN(32512 * RN(1 / tot)) once a row, the
    truncated RN(c * scale), then +1 where (v + 1) * tot <= c * 32512."""
    c = np.asarray(c, np.uint64)
    tot = np.asarray(tot, np.uint64)
    scale = np.float64(BASE) * (np.float64(1.0) / tot.astype(np.float64))
    v = np.trunc(c.astype(np.float64) * scale).astype(np.uint64)
    return v + ((v + 1) * tot <= c * np.uint64(BASE)).astype(np.uint64)


def _edge_pairs(seed):
    rng = np.random.default_rng(seed)
    tots = [1, 2, 3, 255, 256, 257, 32511, 32512, 32513, 65535, 65536, 65537,
            (1 << 17) - 1, 1 << 17, 127 << 9, 254 * 1000, (1 << 31) - 1,
            1 << 31, (1 << 32) - 2, (1 << 32) - 1]
    tots += rng.integers(1, 1 << 32, 200, dtype=np.uint64).tolist()
    tots += (2 ** rng.uniform(0, 32, 200)).astype(np.uint64).clip(1).tolist()
    c, t = [], []
    for tot in tots:
        g = math.gcd(tot, BASE)
        ks = rng.integers(1, g + 1, 4, dtype=np.uint64)   # c * 32512 / tot whole
        cs = {1, max(tot - 1, 1), tot, *(int(k) * (tot // g) for k in ks),
              *rng.integers(1, tot + 1, 16, dtype=np.uint64).tolist()}
        c += sorted(cs)
        t += [tot] * len(cs)
    return np.array(c, np.uint64), np.array(t, np.uint64)


@pytest.mark.parametrize("seed", [0, 1])
def test_quant_div_is_exact_floor(seed):
    c, tot = _edge_pairs(seed)
    assert (c >= 1).all() and (c <= tot).all()
    want = [ci * BASE // ti for ci, ti in zip(c.tolist(), tot.tolist())]
    assert quant_div_np(c, tot).tolist() == want


def test_quant_div_on_random_pairs():
    rng = np.random.default_rng(7)
    tot = rng.integers(1, 1 << 32, 300_000, dtype=np.uint64)
    c = (rng.random(300_000) * tot.astype(np.float64)).astype(np.uint64)
    c = np.clip(c, 1, tot)
    assert np.array_equal(quant_div_np(c, tot), c * np.uint64(BASE) // tot)


def quantize_rows_np(C):
    """quantize_rows with quant_div_np as its division (the kernel's)."""
    C = C.astype(np.uint64)
    tot = C.sum(axis=1, keepdims=True)
    q = np.maximum(quant_div_np(C, np.broadcast_to(tot, C.shape)), 1)
    q[np.arange(len(q)), np.argmax(q, axis=1)] += jcx.QTOTAL - q.sum(axis=1)
    return q


def _rows(climit, seed):
    """Rows at the parameter's extremes: totals just under climit, just at
    it and one halving to three above it, a single hot symbol, all ones,
    ties for the maximum, and random rows."""
    rng = np.random.default_rng(seed)
    rows = [np.ones(256, np.uint64)]
    for target in (climit - 1, climit, 2 * climit - 1, 3 * climit,
                   7 * climit):
        r = rng.integers(1, 64, 256).astype(np.uint64)
        r = np.maximum(r * np.uint64(target) // r.sum(), 1)
        r[rng.integers(0, 256)] += np.uint64(max(target - int(r.sum()), 0))
        rows.append(r)
    hot = np.ones(256, np.uint64)
    hot[rng.integers(0, 256)] = climit - 256
    rows.append(hot)
    tie = np.ones(256, np.uint64)
    tie[[3, 77, 200]] = max((climit - 256) // 3, 2)
    rows.append(tie)
    rows += list(rng.integers(1, max(climit // 128, 2), (6, 256)).astype(
        np.uint64))
    return np.stack(rows).astype(np.uint32)


@pytest.mark.parametrize("climit_log2", [9, 12, 16, 17])
def test_rcx_requant_below_climit_is_a_fixed_point(climit_log2):
    climit = 1 << climit_log2
    C0 = _rows(climit, climit_log2)
    C1 = np.asarray(jcx.rescale_rows_jnp(jnp.asarray(C0), climit))
    q1 = np.asarray(jcx.quantize_rows_jnp(jnp.asarray(C1)))
    C2 = np.asarray(jcx.rescale_rows_jnp(jnp.asarray(C1), climit))
    q2 = np.asarray(jcx.quantize_rows_jnp(jnp.asarray(C2)))
    below = C1.astype(np.int64).sum(axis=1) < climit
    assert below.sum() >= 8
    assert np.array_equal(C2[below], C1[below])
    assert np.array_equal(q2[below], q1[below])
    # a row left at or above climit halves again: the kernel redoes it
    assert not np.array_equal(C2[~below], C1[~below]) or not (~below).any()
    # the kernel's division gives the JAX package's table
    assert np.array_equal(quantize_rows_np(C1), q1)
    # the port's requant, both passes
    tC1, tq1, tcum1 = tcx.model_tables(torch.from_numpy(C0.astype(np.int64)),
                                       climit)
    tC2, tq2, _ = tcx.model_tables(tC1, climit)
    assert np.array_equal(tC1.numpy(), C1) and np.array_equal(tq1.numpy(), q1)
    assert np.array_equal(tC2.numpy(), C2) and np.array_equal(tq2.numpy(), q2)
    assert np.array_equal(tcum1.numpy(), np.cumsum(q1, axis=1) - q1)


def test_rcx_requant_redoes_rows_three_halvings_leave_above_climit():
    climit = 1 << 9
    C0 = np.full((2, 256), 4000, np.uint32)
    C1 = np.asarray(jcx.rescale_rows_jnp(jnp.asarray(C0), climit))
    assert (C1.astype(np.int64).sum(axis=1) >= climit).all()
    C2 = np.asarray(jcx.rescale_rows_jnp(jnp.asarray(C1), climit))
    assert not np.array_equal(C2, C1)
    tC2, _, _ = tcx.model_tables(tcx.model_tables(
        torch.from_numpy(C0.astype(np.int64)), climit)[0], climit)
    assert np.array_equal(tC2.numpy(), C2)


@pytest.mark.parametrize("climit_log2", [9, 16])
def test_rcq_requant_below_climit_is_a_fixed_point(climit_log2):
    climit = 1 << climit_log2
    for C0 in _rows(climit, 100 + climit_log2):
        C1 = np.asarray(jq.rescale_jnp(jnp.asarray(C0), climit))
        if int(C1.astype(np.int64).sum()) >= climit:
            continue
        q1 = np.asarray(jq.quantize_jnp(jnp.asarray(C1)))
        C2 = np.asarray(jq.rescale_jnp(jnp.asarray(C1), climit))
        assert np.array_equal(C2, C1)
        assert np.array_equal(np.asarray(jq.quantize_jnp(jnp.asarray(C2))),
                              q1)
        assert np.array_equal(quantize_rows_np(C1[None])[0], q1)
        tC1, tq1, _ = tcx.model_tables(
            torch.from_numpy(C0[None].astype(np.int64)), climit, rounds=1)
        tC2, tq2, _ = tcx.model_tables(tC1, climit, rounds=1)
        assert np.array_equal(tC1.numpy()[0], C1)
        assert np.array_equal(tq1.numpy()[0], q1)
        assert torch.equal(tC2, tC1) and torch.equal(tq2, tq1)


def _windows(data, k, cbits, wlog, inc, climit, skip):
    """The oracle's CT-RCX model (reference/rcx_ref.py's encode loop
    without the coder) over chunked lanes of `data`: at each window start
    every row requantized (skip None), or only the rows that
    requant_changed (csrc/rcx_model.cuh) does not skip: with skip "total"
    (kernel C) a row whose total is last[r], with skip "touched" (kernel A)
    a row no lane added to since its last requant while last[r] is not 0;
    a requantized row sets last[r] to its new total, or to 0 when that is
    still >= climit. -> [(C, cum)] at each window, and the number of rows
    skipped."""
    x = np.frombuffer(data, np.uint8)
    n = len(x)
    stride = -(-n // k)
    cols = np.zeros(k * stride, np.uint8)
    cols[:n] = x
    cols = cols.reshape(k, stride).T
    rows = 1 << cbits
    C = np.ones((rows, 256), np.uint32)
    cum = np.zeros((rows, 256), np.uint32)
    last = np.zeros(rows, np.int64)
    prev = np.zeros(k, np.uint8)
    touched = np.zeros(rows, bool)
    out, skipped = [], 0
    for j in range(stride):
        if j % (1 << wlog) == 0:
            redo = np.ones(rows, bool)
            if skip == "total":
                redo = (last == 0) | (C.astype(np.int64).sum(axis=1) != last)
            elif skip == "touched":
                redo = (last == 0) | touched
            skipped += int((~redo).sum())
            touched[:] = False
            C[redo] = tcx.rescale_rows_np(C[redo], climit)
            q = tcx.quantize_rows_np(C[redo])
            cum[redo] = np.cumsum(q, axis=1, dtype=np.uint32) - q
            tot = C[redo].astype(np.int64).sum(axis=1)
            last[redo] = np.where(tot < climit, tot, 0)
            out.append((C.copy(), cum.copy()))
        active = -(-(n - j) // stride)
        ctx = np.asarray(tcx.ctx_of(prev[:active], cbits), np.int64)
        C = tcx.update_rows_np(C, ctx, cols[j, :active].astype(np.int64), inc)
        touched[ctx] = True
        prev[:active] = cols[j, :active]
    return out, skipped


@pytest.mark.parametrize("rule", ["total", "touched"])
@pytest.mark.parametrize("wlog", [0, 2])
@pytest.mark.parametrize("climit_log2", [9, 16])
def test_requant_changed_rule_gives_the_full_requant(wlog, climit_log2, rule):
    """Kernels A and C requantize only the rows requant_changed picks (C by
    the rows' totals, a lone block of A by the rows its lanes touched); over
    a whole oracle run (grammar.lsp's CT-RCX shape, K = 32, cbits = 6, at
    the default climit and at one that leaves rows above it after three
    halvings) their counts and cum rows equal a full requant's at every
    window, while most rows are skipped."""
    data = (Path(__file__).resolve().parent.parent / "data"
            / "grammar.lsp").read_bytes()
    args = (data, 32, 6, wlog, 32, 1 << climit_log2)
    full, none = _windows(*args, skip=None)
    part, skipped = _windows(*args, skip=rule)
    assert none == 0 and skipped > len(part) * 64 // 2
    for (C0, cum0), (C1, cum1) in zip(full, part):
        assert np.array_equal(C0, C1) and np.array_equal(cum0, cum1)


@pytest.mark.parametrize("k", [32, 2048])
def test_rcq_subhistogram_fold_gives_the_same_model(k):
    """Kernel D's updates: lane i (thread i % 1024) adds inc to copy
    (thread % 2) of the count row, and the requant threads fold both copies
    into C before each requant. The counts, and so the halvings and tables,
    equal those of one histogram that every lane updates (the JAX
    package's rescale_jnp / quantize_jnp at each step)."""
    rng = np.random.default_rng(k)
    inc, climit = 24, 1 << 14
    copy = (np.arange(k) % 1024) % 2
    one = np.ones(256, np.uint32)
    folded = one.copy()
    subs = np.zeros((2, 256), np.uint32)
    for step in range(40):
        sym = rng.integers(0, 256, k)
        sym[: k // 2] = 0 if step % 3 else sym[: k // 2]    # runs: one cell
        np.add.at(one, sym, np.uint32(inc))
        np.add.at(subs, (copy, sym), np.uint32(inc))
        folded = folded + subs.sum(axis=0, dtype=np.uint32)
        subs[:] = 0
        assert np.array_equal(folded, one)
        one = np.asarray(jq.rescale_jnp(jnp.asarray(one), climit))
        folded = np.asarray(jq.rescale_jnp(jnp.asarray(folded), climit))
        assert np.array_equal(np.asarray(jq.quantize_jnp(jnp.asarray(folded))),
                              np.asarray(jq.quantize_jnp(jnp.asarray(one))))
    assert int(one.astype(np.int64).sum()) > 256     # the model moved


def tree_node(s):
    """ct::tree_node: symbol s (1..255) is node 2^d + p of level d when
    s = (2p + 1) << (7 - d)."""
    tz = (s & -s).bit_length() - 1
    return (1 << (7 - tz)) | (s >> (tz + 1))


def _cum_rows(seed):
    """Sorted cum rows [4, 257] (cum[256] == QTOTAL): random, one hot
    symbol, all ones, random."""
    rng = np.random.default_rng(seed)
    C = rng.integers(1, 3000, (4, 256)).astype(np.uint32)
    C[1, 7] = 60000
    C[2] = 1
    q = quantize_rows_np(C)
    return np.concatenate([np.zeros((4, 1), np.uint64), np.cumsum(q, axis=1)],
                          axis=1)


def test_tree_order_search_matches_sorted_search():
    rng = np.random.default_rng(3)
    assert sorted(tree_node(s) for s in range(1, 256)) == list(range(1, 256))
    cum = _cum_rows(3)
    for r in range(4):
        tree = np.zeros(256, np.uint64)
        for s in range(1, 256):
            tree[tree_node(s)] = cum[r, s]
        for rng_val in rng.integers(1 << 24, 1 << 32, 200, dtype=np.uint64):
            t = int(rng_val) >> 15
            for code in rng.integers(0, t * jcx.QTOTAL, 20, dtype=np.uint64):
                k, c, h = 1, 0, jcx.QTOTAL
                for _ in range(8):
                    v = int(tree[k])
                    right = v * t <= int(code)
                    c, h = (v, h) if right else (c, v)
                    k = 2 * k + right
                sym = int(np.searchsorted(cum[r] * t, code, side="right")) - 1
                assert (k - 256, c, h) == (sym, cum[r, sym], cum[r, sym + 1])


def test_sorted_search_keeps_both_bounds():
    """Kernel C's search over a sorted row: 8 reads, the lower end k moving
    to k | 128 >> it on each right turn, c and h the cum values of the last
    right and left turn."""
    rng = np.random.default_rng(4)
    cum = _cum_rows(4)
    for r in range(4):
        for rng_val in rng.integers(1 << 24, 1 << 32, 200, dtype=np.uint64):
            t = int(rng_val) >> 15
            codes = rng.integers(0, t * jcx.QTOTAL, 20, dtype=np.uint64)
            for code in [0, t * jcx.QTOTAL - 1, *codes.tolist()]:
                k, c, h = 0, 0, jcx.QTOTAL
                for it in range(8):
                    at = k | (128 >> it)
                    v = int(cum[r, at])
                    right = v * t <= int(code)
                    c, h = (v, h) if right else (c, v)
                    k = at if right else k
                sym = int(np.searchsorted(cum[r] * t, code, side="right")) - 1
                assert (k, c, h) == (sym, cum[r, sym], cum[r, sym + 1])
