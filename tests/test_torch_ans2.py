"""CT-ANS2 (adaptive_rans) in the port, on the CPU (the plain versions of
kernels W, X and Y), with exact equality throughout (integer codec:
tolerance 0).

The same seeded inputs go through the JAX package's
ans2_ops.ans2_encode_jax / ans2_decode_jax (XLA on the CPU, no Pallas
kernel), through the port's `device="cpu"` and through the port's copy of
the oracle (reference/ans2_ref.py): the containers must be byte-identical
and each side must decode the others'. Away from the defaults (inc,
limit_log2 up to 255, refresh_log2 past the stream's steps, counts past
2^32) the port is held to the oracle alone: the JAX package keeps counts
and totals as u32 and raises at limit_log2 >= 32 (ROADMAP C10)."""

import numpy as np
import pytest
import torch

from conftest import corpus_file, std_cases

import cpprcoder_tpu_torch as ctt
from cpprcoder_tpu.ops import ans2_ops as jops
from cpprcoder_tpu.reference import ans2_ref as jref
from cpprcoder_tpu_torch.codecs import stream as tstream
from cpprcoder_tpu_torch.core.bytesutil import ByteReader
from cpprcoder_tpu_torch.ops import ans2_kernels, ans2_ops, layout
from cpprcoder_tpu_torch.reference import ans2_ref as tref

CPU = {"device": "cpu"}


def _seeded(n, seed, alphabet=256):
    rng = np.random.default_rng(seed)
    return bytes(rng.integers(0, alphabet, n, dtype=np.uint8))


def _cases():
    cases = {f"std {i}": d for i, d in enumerate(std_cases())}
    cases["grammar.lsp"] = corpus_file("grammar.lsp")
    cases["seeded text"] = bytes(
        np.random.default_rng(6).choice(np.frombuffer(b"etaoin shrdlu\n",
                                                      np.uint8), 2000))
    return cases


CASES = _cases()
# lanes 1 and 2 run one step a byte or two: the largest inputs there are
# cut, so that no plain loop runs more than 2,000 steps
CUT = {1: 1000, 2: 2000}


@pytest.mark.parametrize("lanes", [1, 2, 8, 64])
@pytest.mark.parametrize("case", list(CASES))
def test_ans2_matches_jax_and_oracle(case, lanes):
    data = CASES[case][:CUT.get(lanes)]
    blob = ctt.compress(data, codec="adaptive_rans", lanes=lanes, **CPU)
    assert blob == jops.ans2_encode_jax(data, lanes=lanes)
    assert blob == tref.ans2_encode(data, lanes=lanes)
    assert ctt.decompress(blob, codec="adaptive_rans", **CPU) == data
    assert jops.ans2_decode_jax(blob) == data


@pytest.mark.parametrize("refresh_log2", [0, 1, 2, 3])
@pytest.mark.parametrize("case,lanes", [("grammar.lsp", 2), ("std 7", 8)])
def test_ans2_refresh_matches_jax_and_oracle(case, lanes, refresh_log2):
    """A table every 1, 2, 4 and 8 steps (after the warm-up windows)."""
    data = CASES[case][:CUT.get(lanes)]
    opts = dict(lanes=lanes, refresh_log2=refresh_log2)
    blob = ctt.compress(data, codec="adaptive_rans", **opts, **CPU)
    assert blob == jops.ans2_encode_jax(data, **opts)
    assert blob == tref.ans2_encode(data, **opts)
    assert ctt.decompress(blob, codec="adaptive_rans", **CPU) == data
    assert jops.ans2_decode_jax(blob) == data


def test_each_side_decodes_the_others_containers():
    """The port decodes the JAX package's and both oracles' containers, and
    the JAX package and both oracles decode the port's."""
    for data, lanes in ((corpus_file("xargs.1")[:1600], 4),
                        (_seeded(700, 3, 70), 2), (b"z", 8)):
        mine = ctt.compress(data, codec="adaptive_rans", lanes=lanes, **CPU)
        for blob in (jops.ans2_encode_jax(data, lanes=lanes),
                     jref.ans2_encode(data, lanes=lanes),
                     tref.ans2_encode(data, lanes=lanes)):
            assert ctt.decompress(blob, codec="adaptive_rans", **CPU) == data
        for dec in (jops.ans2_decode_jax, jref.ans2_decode, tref.ans2_decode):
            assert dec(mine) == data


# (data, lanes, options) for the oracle alone: the hard cases of
# chip_smoke.py's phase 3 at a few thousand steps, and header values the
# JAX package does not take
HARD = {
    "limit_log2 9: a rescale at nearly every window":
        (corpus_file("xargs.1")[:2000], 2, dict(limit_log2=9, inc=255)),
    "refresh_log2 past bitlen(steps): warm-up windows only":
        (_seeded(3000, 12, 40), 4, dict(refresh_log2=12)),
    "refresh_log2 255": (_seeded(1500, 13, 40), 2, dict(refresh_log2=255)),
    "limit_log2 255 (never rescales)":
        (b"\x61" * 3000, 8, dict(limit_log2=255, inc=255)),
    "limit_log2 32: past the JAX package's u32":
        (corpus_file("fields.c")[:3000], 4, dict(limit_log2=32)),
    "limit_log2 40": (_seeded(2000, 14, 5), 2, dict(limit_log2=40, inc=200)),
    "inc 0: a static uniform model": (_seeded(1000, 15, 20), 1, dict(inc=0)),
    "inc 1, limit_log2 0 (rescale at every window)":
        (corpus_file("grammar.lsp")[:2400], 2, dict(inc=1, limit_log2=0)),
    "n < K": (b"abcde", 8, {}),
    "n not a multiple of K": (_seeded(64 * 20 + 13, 16, 90), 64,
                              dict(refresh_log2=1)),
    "one-byte run": (b"\x42" * 4000, 16, dict(inc=255)),
    "all 256 values": (bytes(range(256)) * 12, 4, dict(refresh_log2=0)),
}


@pytest.mark.parametrize("case", list(HARD))
def test_ans2_hard_cases_match_the_oracle(case):
    data, lanes, opts = HARD[case]
    blob = ctt.compress(data, codec="adaptive_rans", lanes=lanes, **CPU,
                        **opts)
    assert blob == tref.ans2_encode(data, lanes=lanes, **opts)
    assert ctt.decompress(blob, codec="adaptive_rans", **CPU) == data
    assert tref.ans2_decode(blob) == data


# kernel Y's hard cases (the card runs the same inputs against the plain
# decoder): more words than its ring of 8,192 holds, every lane refilling
# at the same steps (one byte in every lane), a window every step
# (refresh_log2 0) at one warp and past it, and K = 1, 32, 64 around its
# one-warp cut; each against the JAX package (limit_log2 <= 31, C10) and
# the oracle
Y_HARD = {
    "more words than the ring holds": (_seeded(64 * 400, 19), 64, {}),
    "every lane refilling at one step": (b"\x42" * (64 * 300), 64, dict(inc=1)),
    "a window every step, K = 32": (_seeded(32 * 60, 20, 70), 32,
                                    dict(refresh_log2=0)),
    "a window every step, K = 64": (_seeded(64 * 40, 21, 70), 64,
                                    dict(refresh_log2=0)),
    "K = 1": (corpus_file("xargs.1")[:1500], 1, {}),
    "K = 32": (corpus_file("fields.c")[:32 * 70 + 9], 32, {}),
    "K = 64": (corpus_file("fields.c")[:64 * 40 + 33], 64, {}),
}


@pytest.mark.parametrize("case", list(Y_HARD))
def test_y_hard_cases_match_jax_and_the_oracle(case):
    data, lanes, opts = Y_HARD[case]
    blob = ctt.compress(data, codec="adaptive_rans", lanes=lanes, **CPU,
                        **opts)
    assert blob == tref.ans2_encode(data, lanes=lanes, **opts)
    assert blob == jops.ans2_encode_jax(data, lanes=lanes, **opts)
    assert ctt.decompress(blob, codec="adaptive_rans", **CPU) == data
    assert jops.ans2_decode_jax(blob) == data


def _cut_words(blob, k, cut):
    """The container with its word stream `cut` words short."""
    r = ByteReader(blob)
    head = blob[:8 + 4 * k]
    r.raw(8 + 4 * k)
    n_words = r.u32()
    words = r.u16s(n_words)[:n_words - cut]
    return (head + int(len(words)).to_bytes(4, "little")
            + words.astype("<u2").tobytes())


def test_y_word_stream_ending_mid_step_reads_zeros():
    """The word stream cut short inside the last refilling step's words:
    the lanes that refill past its end read 0, in the port's plain decoder
    (and on the card, kernel Y), the JAX package's and the oracle's alike,
    and the bytes before that step still decode."""
    data, k = _seeded(64 * 50, 22, 120), 64
    blob = tref.ans2_encode(data, lanes=k)
    n, steps = len(data), 50
    x2d = layout.pad2d_interleaved(torch.from_numpy(
        np.frombuffer(data, np.uint8).copy()), k, steps)
    lens = layout.lane_lengths_interleaved(n, k, steps, "cpu")
    r_log2 = tref.default_refresh_log2(k, n)
    entries = ans2_ops.window_tables_plain(x2d, n, 8, 18, r_log2)
    ev, _ = ans2_ops.encode_events_plain(x2d, lens, entries, r_log2)
    emits = ((ev & ans2_ops.EMIT) != 0).sum(dim=1)
    last = int(torch.nonzero(emits).max())
    cut = 3
    assert int(emits[last]) > cut      # the end falls inside step `last`
    short = _cut_words(blob, k, cut)
    out = ctt.decompress(short, codec="adaptive_rans", **CPU)
    assert out == tref.ans2_decode(short) == jops.ans2_decode_jax(short)
    assert out[:last * k] == data[:last * k] and out != data


def test_c10_the_jax_package_refuses_limit_log2_32():
    """C10: at limit_log2 >= 32 the JAX package's u32 model raises on
    encode (`U32(1 << limit_log2)`) and on decode, where the oracle and the
    port write and read the same container."""
    data = b"abracadabra" * 20
    for limit_log2 in (32, 33):
        blob = tref.ans2_encode(data, limit_log2=limit_log2)
        assert ctt.compress(data, codec="adaptive_rans", **CPU,
                            limit_log2=limit_log2) == blob
        assert ctt.decompress(blob, codec="adaptive_rans", **CPU) == data
        with pytest.raises(OverflowError):
            jops.ans2_encode_jax(data, limit_log2=limit_log2)
        with pytest.raises(OverflowError):
            jops.ans2_decode_jax(blob)


@pytest.mark.parametrize("limit_log2", [40, 33, 32])
def test_window_tables_past_2_32_match_the_oracles_model(limit_log2):
    """8,192 lanes of 4,100 steps of one byte at inc 255, refresh_log2 13:
    the counts pass 2^32 (at limit_log2 32 the model rescales at step
    4,096, once they have). W's plain version equals the oracle's model
    pass, window for window."""
    k, steps, inc, r_log2 = 8192, 4100, 255, 13
    x = np.full((steps, k), 7, np.uint8)
    n = k * steps
    freqs, cums = ans2_ops.entry_tables(ans2_ops.window_tables_plain(
        torch.from_numpy(x), n, inc, limit_log2, r_log2))
    counts = ans2_ops.window_counts_plain(torch.from_numpy(x), n, inc,
                                          limit_log2, r_log2)
    assert int(counts[-1, 7]) > 1 << 32 or limit_log2 == 32
    snaps = tref._snapshots_and_counts(x, n, k, inc, 1 << limit_log2,
                                       1 << r_log2)
    assert freqs.shape == (len(snaps), 256) == (14, 256)
    for w, (f, c) in enumerate(snaps):
        assert np.array_equal(freqs[w].numpy(), f)
        assert np.array_equal(cums[w].numpy(), c)


def test_stream_words_are_the_decoders_read_order():
    """The events are time-major, so the emitted words masked out of them
    row after row are the container's words: step-major, then lane-major
    (the oracle's emitted[::-1]), at K > 1 and several emits a step."""
    data = _seeded(8 * 300, 18)   # random bytes: most steps emit
    k = 8
    n, steps = len(data), 300
    x2d = layout.pad2d_interleaved(torch.from_numpy(
        np.frombuffer(data, np.uint8).copy()), k, steps)
    lens = layout.lane_lengths_interleaved(n, k, steps, "cpu")
    r_log2 = tref.default_refresh_log2(k, n)
    entries = ans2_ops.window_tables_plain(x2d, n, 8, 18, r_log2)
    ev, states = ans2_ops.encode_events_plain(x2d, lens, entries, r_log2)
    emits = ((ev & ans2_ops.EMIT) != 0).sum(dim=1)
    assert int(emits.max()) >= 4
    r = ByteReader(tref.ans2_encode(data, lanes=k))
    r.u32(), r.u8(), r.u8(), r.u8(), r.u8()
    assert np.array_equal(r.u32s(k), ans2_ops.i32_to_u32(states).numpy())
    n_words = r.u32()
    assert np.array_equal(r.u16s(n_words),
                          ans2_ops.stream_words(ev).numpy())


def test_window_schedule():
    """window_start and n_snapshots against the oracle's is_boundary, and
    the refresh_log2 clamp against its snapshot_index."""
    for r in range(0, 7):
        for steps in (1, 2, 3, 5, 64, 100, 257):
            starts = [t for t in range(steps) if tref.is_boundary(t, 1 << r)]
            assert [ans2_ops.window_start(w, r) for w in range(len(starts))] \
                == starts
            assert ans2_ops.n_snapshots(steps, r) == len(starts)
    for steps in (1, 2, 5, 4023, 1 << 20):
        re = ans2_ops.refresh_eff(255, steps)
        assert re <= 31 and (1 << re) > steps - 1
        for t in (0, steps // 3, steps - 1):
            assert tref.snapshot_index(t, 1 << 255) \
                == tref.snapshot_index(t, 1 << re)


def test_normalize_tables_plain_is_the_oracles():
    """The normalize's plain version (the one W's and Y's device function
    is held to on the card) at count vectors past 2^32, one dominant
    symbol, one symbol alone, all equal and all zero."""
    rng = np.random.default_rng(19)
    rows = [rng.integers(0, 10 ** int(rng.integers(1, 12)), 256)
            for _ in range(20)]
    rows.append(np.eye(256, dtype=np.int64)[3] * (1 << 40) + 1)
    rows.append(np.eye(256, dtype=np.int64)[255] * 99)
    rows += [np.full(256, 1 << 33), np.zeros(256)]
    counts = torch.from_numpy(np.stack(rows).astype(np.int64))
    e = ans2_kernels.normalize_tables(counts)
    f, c = ans2_ops.entry_tables(e)
    assert torch.equal(e, ans2_ops.table_entries(f, c))
    for i, row in enumerate(counts.numpy()):
        want = (tref.normalize_freqs(row, 14) if row.sum()
                else np.zeros(256, np.uint32))
        assert np.array_equal(f[i].numpy(), want)
        assert np.array_equal(c[i].numpy(), tref.exclusive_cumsum(want))
    # rule 5: the one symbol gives 1 to the next (255's to 0)
    assert int(f[-3][255]) == (1 << 14) - 1 and int(f[-3][0]) == 1


def test_lane_counts_header_bytes_and_empty_input():
    """lanes 0 and None pick pick_lanes(n); a lane count that is not a
    power of two raises ValueError (C4), as does a parameter past its
    header byte; n = 0 writes the oracle's 8-byte container."""
    data = b"lane policy " * 30
    assert ctt.compress(data, codec="adaptive_rans", lanes=0, **CPU) \
        == ctt.compress(data, codec="adaptive_rans", **CPU) \
        == tref.ans2_encode(data)
    for opts in (CPU, {"backend": "ref"}):
        for lanes in (3, 6, 100):
            with pytest.raises(ValueError, match="power of two"):
                ctt.compress(data, codec="adaptive_rans", lanes=lanes, **opts)
    for bad in (dict(inc=256), dict(limit_log2=-1), dict(refresh_log2=300)):
        with pytest.raises(ValueError, match="header"):
            ctt.compress(data, codec="adaptive_rans", **bad, **CPU)
    for lanes in (None, 1, 64):
        blob = ctt.compress(b"", codec="adaptive_rans", lanes=lanes, **CPU)
        assert blob == tref.ans2_encode(b"", lanes=lanes) \
            == jops.ans2_encode_jax(b"", lanes=lanes)
        assert len(blob) == 8
        assert ctt.decompress(blob, codec="adaptive_rans", **CPU) == b""


def test_wrappers_check_their_inputs():
    """The kernels' wrappers refuse what the kernels do not take, on the
    CPU as on the card (above 65,536 lanes only on the card: the plain
    versions take any lane count)."""
    x2d = torch.zeros((4, 2), dtype=torch.uint8)
    with pytest.raises(ValueError, match="steps"):
        ans2_kernels.window_tables(x2d, 3, 8, 18, 2)
    with pytest.raises(ValueError, match="uint8"):
        ans2_kernels.window_tables(x2d.to(torch.int32), 8, 8, 18, 2)
    entries = ans2_kernels.window_tables(x2d, 8, 8, 18, 2)
    lens = torch.full((2,), 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="tables"):
        ans2_kernels.encode_events(x2d, lens, entries[:1], 2)
    with pytest.raises(ValueError, match="int64"):
        ans2_kernels.encode_events(x2d, lens, entries.to(torch.int32), 2)
    with pytest.raises(ValueError, match="int16"):
        ans2_kernels.decode_symbols(torch.zeros(3, dtype=torch.int32),
                                    torch.zeros(2, dtype=torch.int32), 8, 8,
                                    18, 2)
    assert ans2_kernels.MAX_LANES == 1 << 16


def test_superblocks_and_pipeline_stage_match_the_jax_package():
    """CT-SB over adaptive_rans (id 13) is the JAX package's container and
    the oracle's, and id 13 works as a pipeline stage."""
    import cpprcoder_tpu
    from cpprcoder_tpu.codecs import stream as jstream

    data = corpus_file("fields.c")[:3000]
    blob = tstream.stream_encode(data, codec="adaptive_rans", sb_log2=10,
                                 **CPU)
    assert blob == jstream.stream_encode(data, codec="adaptive_rans",
                                         sb_log2=10)
    assert blob == tstream.stream_encode(data, codec="adaptive_rans",
                                         sb_log2=10, backend="ref")
    assert tstream.stream_decode(blob, **CPU) == data
    stages = ["rle0", "adaptive_rans"]
    blob = ctt.compress(data, codec="pipeline", stages=stages, **CPU)
    assert blob == cpprcoder_tpu.compress(data, codec="pipeline",
                                          stages=stages)
    assert ctt.decompress(blob, codec="pipeline", **CPU) == data


# Kernel X's second design stages each window's table in shared memory from
# step 16 on where windows there are 16 steps or more (refresh_log2 >= 4),
# in runs of 16 steps, and reads the first 16 steps (every step at
# refresh_log2 < 4) from global memory. Its hard cases: a table every step,
# window edges inside a run of 16 (refresh_log2 3), 16 and 32 steps a
# window, lanes of steps - 1 steps, K = 1 and K = 32; at limit_log2 <= 31
# the JAX package takes them too (C10).
X_HARD = {
    "refresh 0, K=2": (corpus_file("grammar.lsp")[:1500], 2,
                       dict(refresh_log2=0)),
    "refresh 3 (edges inside a run of 16), K=8":
        (_seeded(8 * 300 + 3, 81, 90), 8, dict(refresh_log2=3)),
    "refresh 4, K=4": (corpus_file("fields.c")[:4 * 400 + 1], 4,
                       dict(refresh_log2=4)),
    "refresh 5, lanes of steps - 1, K=32": (_seeded(32 * 120 - 5, 82, 60), 32,
                                            dict(refresh_log2=5)),
    "K=1": (_seeded(1500, 83, 120), 1, {}),
    "K=1, refresh 3": (corpus_file("xargs.1")[:1200], 1,
                       dict(refresh_log2=3, limit_log2=12)),
    "K=32": (corpus_file("fields.c")[:32 * 60 + 9], 32, {}),
    "steps 17 and 16 (one staged step), K=64": (_seeded(64 * 17 - 3, 84),
                                                64, dict(refresh_log2=5)),
}


@pytest.mark.parametrize("case", list(X_HARD))
def test_x_hard_cases_match_jax_and_the_oracle(case):
    data, lanes, opts = X_HARD[case]
    blob = ctt.compress(data, codec="adaptive_rans", lanes=lanes, **opts,
                        **CPU)
    assert blob == jops.ans2_encode_jax(data, lanes=lanes, **opts)
    assert blob == tref.ans2_encode(data, lanes=lanes, **opts)
    assert ctt.decompress(blob, codec="adaptive_rans", **CPU) == data
    assert jops.ans2_decode_jax(blob) == data


def _x_tables_read(stride, length, r, run=16, stage_log2=4):
    """The table kernel X codes each step of a lane of `length` steps with
    (csrc/ans2_encode.cu's control flow): the staged steps [t0, stride) in
    runs of `run` from the top (the top run ragged), the window moving down
    one table at each window start; the steps below t0 by snapshot_index.
    -> {step: table}."""
    used = {}
    t0 = run if r >= stage_log2 and stride > run else stride
    if t0 < stride:
        w = tref.snapshot_index(stride - 1, 1 << r)
        edge = ans2_ops.window_start(w, r)
        m0, m = t0 // run, (stride - 1) // run
        for t in range(length - 1, run * m - 1, -1):
            used[t] = w
        while True:
            if run * m == edge and m > m0:
                w -= 1
                edge = ans2_ops.window_start(w, r)
            m -= 1
            if m < m0:
                break
            for u in range(run):
                used[run * m + u] = w
    for t in range(min(t0, length)):
        used[t] = tref.snapshot_index(t, 1 << r)
    return used


@pytest.mark.parametrize("r", list(range(12)))
def test_x_staged_walk_reads_each_steps_table(r):
    """At every refresh_log2, stride and lane length, kernel X's walk codes
    step t with table snapshot_index(t): no run of the staged path crosses
    a window edge."""
    for stride in list(range(1, 300)) + [1861, 2048, 4010, 4023]:
        for length in (stride, stride - 1):
            want = {t: tref.snapshot_index(t, 1 << r) for t in range(length)}
            assert _x_tables_read(stride, length, r) == want


# the sorted-key normalize (csrc/ans2_model.cuh warp_normalize) in its plain
# form, against the spec's normalize_freqs: 50 seeded count vectors of each
# kind, d > 0 with remainder ties, d < 0, rule 5, all zero, sums near 2^63
def _count_rows(kind, seed, m=50):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(m):
        if kind == "random":
            c = rng.integers(0, 1000, 256)
        elif kind == "equal counts (ties)":
            c = np.full(256, rng.integers(1, 50))
        elif kind == "equal remainders":
            c = rng.integers(0, 4, 256) * 7
        elif kind == "one dominant symbol (d < 0)":
            c = np.ones(256, np.int64)
            c[rng.integers(256)] = rng.integers(1 << 20, 1 << 30)
        elif kind == "one symbol alone (rule 5)":
            c = np.zeros(256, np.int64)
            c[rng.integers(256)] = rng.integers(1, 1 << 40)
        elif kind == "all zero":
            c = np.zeros(256, np.int64)
        elif kind == "sums near 2^63":
            c = rng.integers(0, 1 << 53, 256)
            c[rng.integers(256)] = 1 << 62      # the sum below 2^62 + 2^61
        else:   # "a few present, spread wide"
            c = rng.integers(0, 3, 256) * rng.integers(1, 1 << 20)
        rows.append(np.asarray(c, np.int64))
    return np.stack(rows)


@pytest.mark.parametrize("kind", [
    "random", "equal counts (ties)", "equal remainders",
    "one dominant symbol (d < 0)", "one symbol alone (rule 5)", "all zero",
    "sums near 2^63", "a few present, spread wide"])
def test_normalize_sorted_plain_is_normalize_freqs(kind):
    counts = _count_rows(kind, 100 + len(kind))
    assert counts.sum(1).min() >= 0          # every sum below 2^63
    got = ans2_ops.normalize_sorted_plain(torch.from_numpy(counts)).numpy()
    for row, f in zip(counts, got):
        assert np.array_equal(f, tref.normalize_freqs(row, 14)
                              if row.sum() else np.zeros(256))


def _jax_pass_a(x2d, n, k, inc, limit_log2, r_log2):
    """The JAX package's pass A (ops/ans2_ops.py `_encode_fn`): its warm-up
    windows, then windows of R steps, each `_window_model` then the
    window's histogram_masked -> freqs [windows, 256]."""
    import jax
    import jax.numpy as jnp

    from cpprcoder_tpu.models.table_jax import histogram_masked

    steps = x2d.shape[0]
    r_steps = 1 << r_log2
    lens = jops._warm_lens(r_log2)
    lens += [r_steps] * jops._layout(steps, r_log2)[1]
    # every window's bytes padded to one shape: one compile of each step
    model = jax.jit(jops._window_model, static_argnums=2)
    hist = jax.jit(histogram_masked)
    width = min(max(lens), steps) * k
    counts, total = jnp.ones(256, jnp.uint32), jnp.uint32(256)
    out, off = [], 0
    for length in lens:
        if off >= steps:
            break
        counts, total, freqs = model(counts, total, 1 << limit_log2)
        out.append(np.asarray(freqs))
        xw = np.zeros(width, np.uint8)
        part = x2d[off:off + length].reshape(-1)[:width]
        xw[:len(part)] = part
        n_rem = int(np.clip(n - off * k, 0, length * k))
        counts = counts + hist(jnp.asarray(xw), jnp.int32(n_rem)).astype(
            jnp.uint32) * inc
        total = total + jnp.uint32(inc * n_rem)
        off += length
    return np.stack(out)


# W's hard cases (data, K, inc, limit_log2, refresh_log2), at small sizes
W_HARD = {
    "refresh_log2 0: a table a step": (corpus_file("grammar.lsp")[:300], 2,
                                       8, 18, 0),
    "refresh_log2 31: the warm-up windows alone": (_seeded(400, 90), 4, 8,
                                                   18, 31),
    "K = 65,536, one step": (_seeded(3000, 91), 65536, 8, 18, None),
    "n = 1": (b"q", 1, 8, 18, None),
    "the last window cut short by n": (_seeded(8 * 37 + 3, 92, 30), 8, 8, 18,
                                       3),
    "rescales every window (limit_log2 9)": (_seeded(4 * 300, 93, 40), 4, 8,
                                             9, 3),
    "no rescale (limit_log2 63)": (_seeded(4 * 300, 94, 40), 4, 255, 63, 3),
    "one distinct byte": (bytes(2 * 500), 2, 255, 18, 4),
    "one dominant symbol (d < 0)": (b"\x05" * 1900 + _seeded(100, 95), 4,
                                    255, 30, 5),
}


@pytest.mark.parametrize("case", list(W_HARD))
def test_w_tables_and_entries_match_jax_and_the_oracle(case):
    """window_tables (its plain version on the CPU) equals the oracle's
    model pass window for window, and the JAX package's pass A where that
    takes the parameters (limit_log2 <= 31, C10); its entries are (rcp, f
    | c << 16) of those tables, and X's plain version reads them as the
    tables."""
    data, k, inc, limit_log2, r_log2 = W_HARD[case]
    n = len(data)
    steps = -(-n // k)
    if r_log2 is None:
        r_log2 = tref.default_refresh_log2(k, n)
    x2d = layout.pad2d_interleaved(torch.from_numpy(
        np.frombuffer(data, np.uint8).copy()), k, steps)
    e = ans2_kernels.window_tables(x2d, n, inc, limit_log2, r_log2)
    f, c = ans2_ops.entry_tables(e)
    snaps = tref._snapshots_and_counts(x2d.numpy(), n, k, inc,
                                       1 << limit_log2, 1 << r_log2)
    assert f.shape[0] == len(snaps)
    assert np.array_equal(f.numpy(), np.stack([s[0] for s in snaps]))
    assert np.array_equal(c.numpy(), np.stack([s[1] for s in snaps]))
    assert torch.equal(e, ans2_ops.table_entries(f, c))
    rcp = e & 0xFFFFFFFF
    assert torch.equal(rcp, torch.where(f > 0, 0xFFFFFFFF // f.clamp(min=1), 0))
    if limit_log2 <= 31:
        jf = _jax_pass_a(x2d.numpy(), n, k, inc, limit_log2,
                         min(r_log2, 30))
        assert np.array_equal(jf[:f.shape[0]], f.numpy())


def test_w_scratch_geometry():
    """W's histogram rows a window: the longest window's tiles of
    ans2_kernels.TILE positions, at most MAX_ROWS (a CTA then takes tiles
    y, y + rows, ...), and its scratch the counts and the rows."""
    t, m = ans2_kernels.TILE, ans2_kernels.MAX_ROWS
    assert ans2_kernels.model_scratch(3721, 2, 1861, 5, 64) == (1, 64 * 3072)
    rows, nbytes = ans2_kernels.model_scratch(1029744, 256, 4023, 6, 69)
    assert rows == 64 * 256 // t and nbytes == 69 * (2048 + 1024 * rows)
    assert ans2_kernels.model_scratch(65536 * 40, 65536, 40, 3, 8)[0] == m
    assert ans2_kernels.model_scratch(1, 1, 1, 0, 1) == (1, 3072)
