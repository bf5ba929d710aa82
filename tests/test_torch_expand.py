"""Port expansion (kernel B's plain version, cpprcoder_tpu_torch/ops/expand.py
on CPU tensors) against the JAX merge expansion
(compaction.materialize_rows_t) and the interpret-mode Pallas kernel
(expand_pallas.materialize_rows_pallas), on the grids of test_expand.py:
non-aligned E/K, a may_drop mask, an empty lane. Exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpprcoder_tpu.ops import compaction as jcomp
from cpprcoder_tpu.ops import expand_pallas
from cpprcoder_tpu_torch.ops import compaction as tcomp
from cpprcoder_tpu_torch.ops import expand

expand_pallas._INTERPRET = True


def _rand_events(e, k, seed, p_emit=0.5, run_max=3):
    rng = np.random.default_rng(seed)
    emit = rng.random((e, k)) < p_emit
    first = rng.integers(0, 256, (e, k), dtype=np.uint32)
    carry = rng.integers(0, 2, (e, k), dtype=np.uint32)
    run = rng.integers(0, run_max + 1, (e, k), dtype=np.uint32)
    ev = (np.uint32(1) << 31) | (first << 23) | (carry << 22) | run
    return np.where(emit, ev, 0).astype(np.uint32)


def _l2_for(events):
    _, sizes = jcomp.materialize_rows_t(jnp.asarray(events), 8)
    m = int(np.asarray(sizes).max())
    l2 = 8
    while l2 < m:
        l2 *= 2
    return l2


def _check(ev, may_drop=True):
    l2 = _l2_for(ev)
    md_j = True if may_drop is True else jnp.asarray(may_drop)
    ref_rows, ref_sizes = jcomp.materialize_rows_t(jnp.asarray(ev), l2, md_j)
    pl_rows, pl_sizes = expand_pallas.materialize_rows_pallas(
        jnp.asarray(ev), l2, md_j)
    md_t = True if may_drop is True else torch.from_numpy(may_drop)
    rows, sizes = expand.materialize_rows(
        torch.from_numpy(ev.view(np.int32)), l2, md_t)
    assert rows.dtype == torch.uint8 and sizes.dtype == torch.int32
    for want_rows, want_sizes in ((ref_rows, ref_sizes), (pl_rows, pl_sizes)):
        assert np.array_equal(sizes.numpy(), np.asarray(want_sizes))
        assert np.array_equal(rows.numpy(), np.asarray(want_rows))
    return rows, sizes


@pytest.mark.parametrize("e,k,seed", [
    (18, 8, 0), (34, 128, 1), (130, 200, 2), (257, 64, 3)])
def test_matches_jax_and_pallas(e, k, seed):
    _check(_rand_events(e, k, seed))


def test_matches_with_may_drop_mask():
    md = np.zeros(16, bool)
    md[::2] = True
    _check(_rand_events(40, 16, 7), md)


def test_empty_and_sparse_lanes():
    ev = _rand_events(24, 12, 9, p_emit=0.15)
    ev[:, 3] = 0
    _, sizes = _check(ev)
    assert int(sizes[3]) == 0


def test_auto_row_width_and_long_runs():
    """l2=None picks a 4-aligned width; runs far beyond the Pallas kernel's
    R2_MAX cap expand the same as the JAX searchsorted spec."""
    ev = _rand_events(50, 6, 11, run_max=900)
    rows, sizes = expand.materialize_rows(torch.from_numpy(ev.view(np.int32)))
    assert rows.shape[1] % 4 == 0 and rows.shape[1] >= int(sizes.max())
    flat, jsizes = jcomp._materialize_searchsorted(
        jnp.asarray(ev.T), int(sizes.sum()))
    assert np.array_equal(sizes.numpy(), np.asarray(jsizes))
    ours = np.concatenate([rows.numpy()[i, :s] for i, s in enumerate(sizes.tolist())])
    assert np.array_equal(ours, np.asarray(flat))


def test_longest_run_matches_jax():
    """One lane whose only event carries the longest run the 22-bit field
    holds (2^22 - 1 bytes of 0xFF) after its dropped first byte: the write
    pass's long-run path on the card; here the plain version against the
    JAX materialize_rows_t at l2 = 2^22."""
    ev = np.zeros((3, 1), np.uint32)
    ev[1, 0] = (1 << 31) | (0x5A << 23) | ((1 << 22) - 1)
    l2 = 1 << 22
    jrows, jsizes = jcomp.materialize_rows_t(jnp.asarray(ev), l2, True)
    rows, sizes = expand.materialize_rows(torch.from_numpy(ev.view(np.int32)), l2)
    assert int(sizes[0]) == (1 << 22) - 1 == int(np.asarray(jsizes)[0])
    assert np.array_equal(rows.numpy(), np.asarray(jrows))
    assert int(rows[0, :(1 << 22) - 1].min()) == 0xFF and int(rows[0, -1]) == 0


def test_first_emit_in_a_later_tile_with_mask_matches_jax():
    """Lanes whose first emit comes only after 32, 64 or 96 silent steps
    (the write pass's warp reads 64 steps of its lane a tile and scans
    32 at a time), under a
    may_drop mask: the dummy is dropped in whichever tile holds it, and
    only where the mask allows."""
    ev = _rand_events(130, 24, 13, run_max=40)
    for i in range(24):
        ev[:32 * (i % 4) + i % 5, i] = 0
    md = np.zeros(24, bool)
    md[1::2] = True
    _check(ev, md)


@pytest.mark.parametrize("may_drop,want", [(True, (None, 1)), (False, (None, 0))])
def test_drop_mask_of_a_bool_is_a_flag(may_drop, want):
    """The kernel's passes take a bool may_drop as a flag (no mask tensor);
    a [K] mask goes as uint8."""
    assert expand.drop_mask(may_drop, 5, "cpu") == want
    md, flag = expand.drop_mask(torch.tensor([1, 0, 1, 1, 0], dtype=torch.bool),
                                5, "cpu")
    assert flag == 0 and md.dtype == torch.uint8
    assert md.tolist() == [1, 0, 1, 1, 0]


def test_layout_and_be_words_match_jax():
    ev = _rand_events(33, 20, 5)
    pcnt, pin, dropped, sizes = tcomp.payload_layout_t(
        torch.from_numpy(ev.view(np.int32)))
    jp, jstart, jdrop, jsizes, _ = jcomp.payload_layout_t(jnp.asarray(ev))
    assert np.array_equal(pcnt.numpy(), np.asarray(jp))
    assert np.array_equal(dropped.numpy(), np.asarray(jdrop))
    assert np.array_equal(sizes.numpy(), np.asarray(jsizes))
    offs = np.cumsum(np.asarray(jsizes)) - np.asarray(jsizes)
    assert np.array_equal(pin.numpy() + offs[None, :], np.asarray(jstart))
    rows = np.random.default_rng(1).integers(0, 256, (5, 24), dtype=np.uint8)
    got = tcomp.rows_to_be_words(torch.from_numpy(rows)).numpy().view(np.uint32)
    assert np.array_equal(got, np.asarray(jcomp.rows_to_be_words(jnp.asarray(rows))))


def test_bad_may_drop_and_short_l2_raise():
    ev = torch.from_numpy(_rand_events(10, 4, 2).view(np.int32))
    with pytest.raises(ValueError):
        expand.materialize_rows(ev, 64, torch.ones(5, dtype=torch.bool))
    with pytest.raises(ValueError):
        expand.materialize_rows(ev, 1)
    with pytest.raises(ValueError):
        expand.materialize_rows(ev.to(torch.int64))
