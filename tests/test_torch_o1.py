"""CT-RC3 (adaptive_o1) in the port, on the CPU (the plain versions of
kernels U and V, and kernel B's), with exact equality throughout (integer
codec: tolerance 0).

The same seeded inputs go through the JAX package's
o1_ops.o1_encode_jax / o1_decode_jax (XLA scans on the CPU, no Pallas
kernel; at pick_inc's defaults only, where its byte-split row extraction
is exact) and through the port's `device="cpu"`: the containers must be
byte-identical, equal to the oracle (the port's copy of
reference/o1_ref.py), and decode on both sides. At other parameters the
port is held to the oracle wherever the oracle ends, inside C8's bound
(ops/o1_ops.py) and past it (fault P6); a step whose t = range / tot_eff
is 0 raises ValueError on encode and CorruptContainerError on decode."""

import numpy as np
import pytest
import torch

from conftest import corpus_file, std_cases

import cpprcoder_tpu_torch as ctt
from cpprcoder_tpu.codecs.pipeline import pipeline_decode, pipeline_encode
from cpprcoder_tpu.ops import o1_ops as jops
from cpprcoder_tpu.reference import o1_ref as jref
from cpprcoder_tpu_torch.core.bytesutil import ByteWriter, CorruptContainerError
from cpprcoder_tpu_torch.ops import expand, layout, o1_kernels, o1_ops
from cpprcoder_tpu_torch.reference import o1_ref as tref

CPU = {"device": "cpu"}


def _seeded(n, seed, alphabet=256):
    rng = np.random.default_rng(seed)
    return bytes(rng.integers(0, alphabet, n, dtype=np.uint8))


def _textish(n, seed):
    """Half lowercase letters, half random bytes (seeded)."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(97, 123, n // 2, dtype=np.uint8),
                           rng.integers(0, 256, n - n // 2, dtype=np.uint8)]
                          ).tobytes()


def _cases():
    cases = {f"std {i}": d for i, d in enumerate(std_cases())}
    cases["grammar.lsp"] = corpus_file("grammar.lsp")
    cases["seeded text"] = bytes(
        np.random.default_rng(6).choice(np.frombuffer(b"etaoin shrdlu\n",
                                                      np.uint8), 2000))
    return cases


CASES = _cases()
# lanes 1 and 2 run one step a byte or two: the largest inputs there are
# cut, so that no plain loop runs more than 1,000 steps
CUT = {1: 1000, 2: 2000}


@pytest.mark.parametrize("lanes", [1, 2, 8, 64])
@pytest.mark.parametrize("case", list(CASES))
def test_o1_matches_jax_and_oracle(case, lanes):
    data = CASES[case][:CUT.get(lanes)]
    blob = ctt.compress(data, codec="adaptive_o1", lanes=lanes, **CPU)
    assert blob == jops.o1_encode_jax(data, lanes=lanes)
    assert blob == tref.o1_encode(data, lanes=lanes)
    assert ctt.decompress(blob, codec="adaptive_o1", **CPU) == data
    assert jops.o1_decode_jax(blob) == data


# (data, lanes, options) for the oracle: the hard cases of chip_smoke.py's
# phase 3, at a few thousand steps, and parameters inside C8's bound
HARD = {
    "limit1_log2 9: rows halve nearly every step":
        (corpus_file("xargs.1")[:2000], 1, dict(limit1_log2=9)),
    "t0 rescales (limit0_log2 10)":
        (_seeded(3000, 12, 50), 2, dict(limit0_log2=10, inc=16)),
    "n < K: empty lanes": (b"abcde", 8, {}),
    "one-byte run: every update on one cell":
        (b"\x61" * 3000, 16, dict(inc=255)),
    "u32 table, lanes 1 (t1[7][7] passes 2^16)":
        (b"\x07" * 2200 + bytes(range(256)) * 2, 1,
         dict(blend_log2=0, limit1_log2=17)),
    "u32 table, lanes 4":
        (b"\x07" * 6000 + bytes(range(256)) * 4, 4,
         dict(blend_log2=0, limit1_log2=17)),
    "blend 12 (8.4 M total)": (b"abracadabra" * 50, 1,
                               dict(inc=32, blend_log2=12)),
    "blend 0, large inc": (_seeded(2000, 13, 20), 4,
                           dict(inc=200, blend_log2=0, limit1_log2=13)),
    "limit1 and limit0 past 2^16": (_seeded(2500, 14, 9), 2,
                                    dict(limit1_log2=18, limit0_log2=20,
                                         blend_log2=2)),
    "inc 0: a static model": (corpus_file("xargs.1")[:1200], 2, dict(inc=0)),
    # kernel V's hard cases (the card runs the same inputs, with 2,048
    # lanes on a one-byte run beside them): every row halved every step
    # (limit1_log2 8), rows halving at 64 lanes (9), t0 every step
    # (limit0_log2 8), 64 lanes on the same bytes (all of them taking one
    # row over its limit in one step), a one-byte run at 256 lanes (every
    # atomic on one address), 256 symbols in one warp (K = 32), and K = 1,
    # 32 and 64
    "limit1_log2 8: every row halves every step":
        (_textish(300, 47), 2, dict(limit1_log2=8)),
    "limit1_log2 9 at 64 lanes": (_textish(64 * 50 + 3, 48), 64,
                                  dict(limit1_log2=9)),
    "limit0_log2 8: t0 halves every step": (_seeded(4000, 49, 60), 4,
                                            dict(limit0_log2=8)),
    "64 lanes crossing a row together": (_textish(80, 50) * 64, 64, {}),
    "one-byte run at 256 lanes": (bytes(256 * 40), 256, {}),
    "256 symbols in one warp": (bytes(i % 256 for i in range(32 * 150)), 32,
                                {}),
    "K = 1": (_textish(1500, 51), 1, {}),
    "K = 32": (_textish(32 * 60 + 5, 52), 32, {}),
    "K = 64": (_textish(64 * 40 + 3, 53), 64, {}),
}


@pytest.mark.parametrize("case", list(HARD))
def test_o1_hard_cases_match_the_oracle(case):
    data, lanes, opts = HARD[case]
    blob = ctt.compress(data, codec="adaptive_o1", lanes=lanes, **CPU,
                        **opts)
    assert blob == tref.o1_encode(data, lanes=lanes, **opts)
    assert ctt.decompress(blob, codec="adaptive_o1", **CPU) == data
    assert tref.o1_decode(blob) == data


@pytest.mark.parametrize("case", [c for c in HARD if not HARD[c][2]])
def test_o1_hard_cases_at_the_defaults_match_jax(case):
    """The hard cases at pick_inc's defaults, where the JAX package is
    exact (C8): its container equals the port's."""
    data, lanes, _ = HARD[case]
    blob = ctt.compress(data, codec="adaptive_o1", lanes=lanes, **CPU)
    assert blob == jops.o1_encode_jax(data, lanes=lanes)
    assert jops.o1_decode_jax(blob) == data


def _word_rows(data, k):
    n = len(data)
    steps = -(-n // k)
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    lens = layout.lane_lengths(n, k, steps, "cpu")
    params = (tref.pick_inc(k), 11, 15, 5)
    rows, sizes = expand.materialize_rows(o1_ops.encode_events_plain(
        layout.pad2d_chunked(x, k, steps), lens, *params))
    return layout.decode_words(rows, sizes), sizes, lens, n, steps, params


@pytest.mark.parametrize("rows", ["one word row", "rows ending at a word edge"])
def test_decode_reads_zeros_past_the_word_rows(rows):
    """decode_symbols_plain (kernel V's plain version, which the card holds
    V to on the same rows) reads zeros past a lane's word row: rows cut
    after the longest lane's last word (three lanes' payloads end on a
    word edge) decode as with the zero row after them, and a single row
    (l4 = 1) as with every later row zeroed."""
    data = _seeded(8 * 120, 3, 40)
    words, sizes, lens, n, steps, params = _word_rows(data, 8)
    assert int(sizes.max()) % 4 == 0 and int((sizes % 4 == 0).sum()) == 3
    if rows == "one word row":
        cut, same = words[:1].contiguous(), words.clone()
        same[1:] = 0
    else:
        cut, same = words[:int(sizes.max()) // 4].contiguous(), words
    out = o1_ops.decode_symbols_plain(cut, lens, n, steps, *params)
    assert torch.equal(out, o1_ops.decode_symbols_plain(same, lens, n, steps,
                                                        *params))
    if rows != "one word row":
        assert out.numpy().tobytes() == data


def test_u32_table_sizes_and_choice():
    """The u32 cases write the oracle's 1,223 and 1,302 bytes, and the
    table choice follows B1 + K*inc < 2^16."""
    data = b"\x07" * 6000 + bytes(range(256)) * 4
    sizes = [len(tref.o1_encode(data, lanes=k, blend_log2=0, limit1_log2=17))
             for k in (1, 4)]
    assert sizes == [1223, 1302]
    assert o1_ops.table_wide(1, 32, 17)
    assert not o1_ops.table_wide(256, 32, 11)    # kennedy.xls's defaults
    assert not o1_ops.table_wide(8192, 1, 11)
    assert o1_ops.table_wide(65536, 1, 11)        # K*inc + 512 > 2^16


def test_c8_bound_values():
    """2^blend * B1 + B0 at the re-anchor's observation: "abracadabra" x
    50 at one lane, inc 32: blend 12 gives 8,417,279 (inside), blend 14
    33.6 M (outside)."""
    assert o1_ops.model_bound(1, 32, 11, 15, 12) == 4096 * 2047 + 32767
    assert o1_ops.model_bound(1, 32, 11, 15, 14) == 16384 * 2047 + 32767
    assert o1_ops.model_bound(1, 32, 11, 15, 14) > o1_ops.TOTAL_LIMIT
    # pick_inc's defaults stay inside at every lane count
    for k in 2 ** np.arange(0, 17):
        k = int(k)
        assert o1_ops.model_bound(k, tref.pick_inc(k), tref.LIMIT1_LOG2,
                                  tref.LIMIT0_LOG2, tref.BLEND_LOG2) \
            <= o1_ops.TOTAL_LIMIT
        o1_ops.check_params(1, tref.pick_inc(k), tref.LIMIT1_LOG2,
                            tref.LIMIT0_LOG2, tref.BLEND_LOG2)


@pytest.mark.parametrize("opts", [dict(blend_log2=14), dict(limit1_log2=24),
                                  dict(limit0_log2=25),
                                  dict(limit1_log2=14, blend_log2=11)])
def test_outside_the_bound_raises(opts):
    """Outside C8's bound on "abracadabra" x 50 at one lane, inc 32 (fault
    P6): where the oracle ends (limit1_log2 24, limit0_log2 25, limit1_log2
    14 with blend_log2 11) the port writes its bytes and decodes its
    container, on the CPU path and in the kernels' wrappers; at
    blend_log2 14 (the oracle does not end) encode raises ValueError at the
    first step whose t is 0, step 100, the wrapper too, and a header with n
    >= 1 at blend_log2 24 (t = 0 at step 0 whatever the payload) raises
    CorruptContainerError on decode."""
    data = b"abracadabra" * 50
    p = {**dict(inc=32, limit1_log2=11, limit0_log2=15, blend_log2=5), **opts}
    params = (p["inc"], p["limit1_log2"], p["limit0_log2"], p["blend_log2"])
    x2d = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).reshape(-1, 1)
    lens = torch.tensor([len(data)], dtype=torch.int32)
    if opts == dict(blend_log2=14):
        with pytest.raises(ValueError, match="step 100, lane 0"):
            ctt.compress(data, codec="adaptive_o1", lanes=1, **CPU, **opts)
        with pytest.raises(ValueError, match="step 100, lane 0"):
            o1_kernels.encode_events(x2d, lens, *params)
        head = o1_ops.header(len(data), 1, False, p["inc"], p["limit1_log2"],
                             p["limit0_log2"], 24)
        blob = head.u16s([20]).getvalue() + bytes(20)
        with pytest.raises(CorruptContainerError, match="step 0"):
            ctt.decompress(blob, codec="adaptive_o1", **CPU)
        return
    blob = ctt.compress(data, codec="adaptive_o1", lanes=1, inc=32, **CPU,
                        **opts)
    oracle = tref.o1_encode(data, lanes=1, inc=32, **opts)
    assert blob == oracle
    assert len(oracle) == {"limit0_log2": 114}.get(next(iter(opts)), 106)
    assert ctt.decompress(oracle, codec="adaptive_o1", **CPU) == data
    assert torch.equal(o1_kernels.encode_events(x2d, lens, *params),
                       o1_ops.encode_events_plain(x2d, lens, *params))


# fault P6: inputs whose parameters pass C8's bound (at lanes 64 it is
# 16,781,055 > 2^24), which the oracle writes and decodes; the port writes
# its bytes and decodes its containers (20,000 zeros at lanes 1 run on the
# card; 2,500 here, where the plain loops take about a millisecond a step:
# row 0 still reaches 2^16 and halves, at step 2,041)
P6_OPTS = dict(inc=32, limit1_log2=16, limit0_log2=12, blend_log2=8)
P6 = {
    "b'a' at lanes 64": (b"a", 64, P6_OPTS),
    "alice29.txt[:488] at lanes 64": (corpus_file("alice29.txt")[:488], 64,
                                      P6_OPTS),
    "grammar.lsp at lanes 2": (corpus_file("grammar.lsp"), 2, P6_OPTS),
    "2,500 zeros at lanes 1": (bytes(2500), 1, P6_OPTS),
    "xargs.1 at lanes 4, limits 16 / 16": (
        corpus_file("xargs.1"), 4, dict(P6_OPTS, limit0_log2=16)),
}


@pytest.mark.parametrize("case", list(P6))
def test_p6_inputs_match_the_oracle(case):
    data, lanes, opts = P6[case]
    oracle = tref.o1_encode(data, lanes=lanes, **opts)
    assert ctt.compress(data, codec="adaptive_o1", lanes=lanes, **CPU,
                        **opts) == oracle
    assert ctt.decompress(oracle, codec="adaptive_o1", **CPU) == data


@pytest.mark.parametrize("blend_log2", [24, 255])
def test_p6_empty_input_at_any_blend(blend_log2):
    """n = 0 writes and reads the oracle's 9-byte header at any
    parameters, blend_log2 24 and 255 among them."""
    blob = ctt.compress(b"", codec="adaptive_o1", lanes=1, **CPU,
                        blend_log2=blend_log2)
    assert blob == tref.o1_encode(b"", lanes=1, blend_log2=blend_log2)
    assert len(blob) == 9
    assert ctt.decompress(blob, codec="adaptive_o1", **CPU) == b""


def test_p6_a_later_step_with_t_zero_raises():
    """Ten zeros at lanes 1, blend_log2 23: step 0 has t = 1 (tot_eff =
    2^31 + 256, and the range left is 2^23 + 1, shifted once); step 1 codes
    against row 0 grown by inc, tot_eff above that range, so t = 0 there. Encode raises ValueError naming step 1 (the
    oracle does not end there: it is not run), and the decoder meets the
    same step on a zero payload (symbol 0 at step 0) and raises
    CorruptContainerError; the wrappers and the plain versions agree."""
    data = bytes(10)
    opts = dict(inc=32, limit1_log2=16, limit0_log2=16, blend_log2=23)
    with pytest.raises(ValueError, match="step 1, lane 0"):
        ctt.compress(data, codec="adaptive_o1", lanes=1, **CPU, **opts)
    x2d = torch.zeros((10, 1), dtype=torch.uint8)
    lens = torch.tensor([10], dtype=torch.int32)
    params = tuple(opts.values())
    trip, _ = o1_ops.model_triples_plain(x2d, lens, *params)
    with pytest.raises(ValueError, match="step 1, lane 0"):
        o1_ops.coder_events_plain(trip)
    # row 0 reaches 512 at step 8: tot_eff = 2^32 + tot0, marked (0, 0,
    # 2^32 - 1); a fresh coder (range 2^32 - 1, so t = 1) still reports it
    assert trip[7, 2].item() < 0 and trip[8].tolist() == [[0], [0], [-1]]
    with pytest.raises(ValueError, match="step 8, lane 0"):
        o1_ops.coder_events_plain(trip[8:], j0=8)
    blob = o1_ops.header(10, 1, False, *params).u16s([8]).getvalue() \
        + bytes(8)
    with pytest.raises(CorruptContainerError, match="step 1, lane 0"):
        ctt.decompress(blob, codec="adaptive_o1", **CPU)
    words = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(CorruptContainerError, match="step 1, lane 0"):
        o1_kernels.decode_symbols(words, lens, 10, 10, *params)
    assert o1_ops.card_counts_fit(10, 1, *params[:3])
    assert not o1_ops.card_counts_fit(1 << 22, 1 << 12, 255, 32, 11)
    assert o1_ops.card_counts_fit(1 << 22, 1 << 12, 255, 31, 31)


def test_each_side_decodes_the_others_containers():
    """The port decodes the JAX package's and the oracles' containers, and
    the JAX package and both oracles decode the port's."""
    for data, lanes in ((corpus_file("grammar.lsp")[:1600], 4),
                        (_seeded(700, 3, 70), 2), (b"z", 8)):
        mine = ctt.compress(data, codec="adaptive_o1", lanes=lanes, **CPU)
        for blob in (jops.o1_encode_jax(data, lanes=lanes),
                     jref.o1_encode(data, lanes=lanes),
                     tref.o1_encode(data, lanes=lanes)):
            assert ctt.decompress(blob, codec="adaptive_o1", **CPU) == data
        for dec in (jops.o1_decode_jax, jref.o1_decode, tref.o1_decode):
            assert dec(mine) == data


def test_lane_counts_and_empty_input():
    """lanes 0 and None pick pick_lanes(n); a lane count that is not a
    power of two, or above 65,536, raises ValueError; n = 0 writes the
    oracle's 9-byte container."""
    data = b"lane policy " * 30
    assert ctt.compress(data, codec="adaptive_o1", lanes=0, **CPU) \
        == ctt.compress(data, codec="adaptive_o1", **CPU) \
        == tref.o1_encode(data)
    for lanes in (3, 6, 100):
        with pytest.raises(ValueError, match="power of two"):
            ctt.compress(data, codec="adaptive_o1", lanes=lanes, **CPU)
    x2d = torch.zeros((1, 1 << 17), dtype=torch.uint8)
    with pytest.raises(ValueError, match="lanes"):
        o1_kernels.encode_events(x2d, torch.ones(1 << 17, dtype=torch.int32),
                                 1, 11, 15, 5)
    for lanes in (None, 1, 64):
        blob = ctt.compress(b"", codec="adaptive_o1", lanes=lanes, **CPU)
        assert blob == tref.o1_encode(b"", lanes=lanes) \
            == jops.o1_encode_jax(b"", lanes=lanes)
        assert ctt.decompress(blob, codec="adaptive_o1", **CPU) == b""


# kernel U's two passes alternate over chunks of steps, the model and the
# lanes' coder state carried across the edges; its plain version does the
# same. (data, lanes, options, chunk): steps one below, at and one past the
# chunk, chunks of one step, the last lane ending inside a chunk, every row
# halved every step, and a one-byte run at 256 lanes (every update on one
# cell), each across several chunk edges
CHUNKED = {
    "steps one below the chunk": (_textish(8 * 60, 54), 8, {}, 61),
    "steps at the chunk": (_textish(8 * 60, 54), 8, {}, 60),
    "steps one past the chunk": (_textish(8 * 60, 54), 8, {}, 59),
    "chunks of one step": (_textish(4 * 50, 55), 4, {}, 1),
    "the last lane ending mid-chunk": (_textish(8 * 50 + 17, 56), 8, {}, 20),
    "every row halved every step, chunks of 7":
        (_textish(120, 47), 2, dict(limit1_log2=8), 7),
    "one-byte run at 256 lanes, chunks of 6": (bytes(256 * 20), 256, {}, 6),
}


def _chunked_inputs(case):
    data, k, opts, chunk = CHUNKED[case]
    n = len(data)
    steps = -(-n // k)
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    params = (opts.get("inc", tref.pick_inc(k)),
              opts.get("limit1_log2", tref.LIMIT1_LOG2),
              opts.get("limit0_log2", tref.LIMIT0_LOG2),
              opts.get("blend_log2", tref.BLEND_LOG2))
    return (data, k, opts, chunk, steps, layout.pad2d_chunked(x, k, steps),
            layout.lane_lengths(n, k, steps, "cpu"), params)


@pytest.mark.parametrize("case", list(CHUNKED))
def test_u_passes_over_chunks_match_the_oracle(case):
    """The composition over chunks (encode_events on the CPU) gives the
    events of one chunk, and the oracle's container; the model pass over
    chunks gives the one pass's triples, and the coder pass over them the
    same events."""
    data, k, opts, chunk, steps, x2d, lens, params = _chunked_inputs(case)
    ev = o1_kernels.encode_events(x2d, lens, *params, chunk_steps=chunk)
    whole = o1_ops.encode_events_plain(x2d, lens, *params)
    assert torch.equal(ev, whole)
    trip = o1_kernels.model_triples(x2d, lens, *params)
    assert trip.shape == (steps, 3, k) and trip.dtype == torch.int32
    assert torch.equal(o1_kernels.coder_events(trip), whole)
    model, parts = None, []
    for j0 in range(0, steps, chunk):
        part, model = o1_ops.model_triples_plain(
            x2d, lens, *params, j0=j0, j1=min(steps, j0 + chunk), model=model)
        parts.append(part)
    assert torch.equal(torch.cat(parts), trip)
    ended = torch.arange(steps)[:, None] >= lens[None, :]
    assert bool((trip.permute(1, 0, 2)[:, ended] == 0).all())
    rows, sizes = expand.materialize_rows(ev)
    blob = layout.assemble(lambda wide: o1_ops.header(len(data), k, wide,
                                                      *params),
                           rows.numpy(), sizes.numpy())
    assert blob == tref.o1_encode(data, lanes=k, **opts)


@pytest.mark.parametrize("case", [c for c in CHUNKED if not CHUNKED[c][2]])
def test_u_passes_over_chunks_match_jax_events(case):
    """At pick_inc's defaults (where the JAX package is exact, C8) the
    events over chunks equal the JAX package's `_encode_fn` scan's."""
    data, k, _, chunk, steps, x2d, lens, params = _chunked_inputs(case)
    ev = o1_kernels.encode_events(x2d, lens, *params, chunk_steps=chunk)
    jev, _, _ = jops._encode_fn(steps, k, *params)(
        x2d.numpy(), lens.numpy().astype(np.int32))
    want = np.asarray(jev).astype(np.uint32).reshape(k, -1).T
    assert np.array_equal(ev.numpy().view(np.uint32), want)


def test_u_chunk_steps_keep_the_triples_capped():
    """The wrapper's chunks: a stream in PIPE_CHUNKS chunks of at least
    PIPE_MIN_STEPS steps, as many as keep two buffers of triples (12 bytes
    a lane a step) within TRIPLE_BYTES, at least one, at most the
    stream's."""
    cap = o1_kernels.TRIPLE_BYTES
    assert o1_kernels.default_chunk_steps(65536, 10 ** 6) == cap // (24 * 65536)
    assert o1_kernels.default_chunk_steps(256, 4023) == 503
    assert o1_kernels.default_chunk_steps(8, 2048) == 256
    assert o1_kernels.default_chunk_steps(2, 1861) == 256
    assert o1_kernels.default_chunk_steps(256, 100) == 100
    for k in (1, 256, 2048, 65536):
        for steps in (1, 1000, 1 << 20):
            c = o1_kernels.default_chunk_steps(k, steps)
            assert 1 <= c <= steps and 2 * 12 * k * c <= cap


def test_run_field_guard():
    """A lane's pending 0xFF run must fit the event's 22-bit field: 3*L + 2
    < 2^22, else ValueError, as for CT-RC1 and CT-RC2."""
    with pytest.raises(ValueError, match="split the input"):
        o1_ops.o1_encode(np.zeros(1 << 21, np.uint8), lanes=1, device="cpu")


def test_plain_versions_keep_the_kernels_contract():
    """encode_events_plain writes 3 slots a step and two flush rows, which
    kernel B's plain version expands into the oracle's payload; the
    decoder's plain version inverts it."""
    data = corpus_file("grammar.lsp")[:1200]
    n, k = len(data), 4
    steps = -(-n // k)
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    lens = layout.lane_lengths(n, k, steps, "cpu")
    params = (tref.pick_inc(k), 11, 15, 5)
    stats = {}
    ev = o1_ops.encode_events_plain(layout.pad2d_chunked(x, k, steps), lens,
                                    *params, stats=stats)
    assert ev.shape == (3 * steps + 2, k) and ev.dtype == torch.int32
    assert stats["rows_halved"] > 0
    blob = ctt.compress(data, codec="adaptive_o1", lanes=k, **CPU)
    assert blob == tref.o1_encode(data, lanes=k)
    words = layout.decode_words(*expand.materialize_rows(ev))
    out = o1_kernels.decode_symbols(words, lens, n, steps, *params)
    assert out.numpy().tobytes() == data


def test_pipeline_with_an_adaptive_o1_stage_matches_jax():
    data = corpus_file("grammar.lsp")[:2000]
    stages = [("blocksort", {"block_log2": 9}), "mtf1",
              ("adaptive_o1", {"lanes": 2})]
    blob = ctt.compress(data, codec="pipeline", stages=stages, **CPU)
    assert blob[:4] == bytes([3, 4, 8, 11])
    assert blob == pipeline_encode(data, stages=stages)
    assert ctt.decompress(blob, codec="pipeline", **CPU) == data
    assert pipeline_decode(blob) == data
    assert ctt.get_codec_by_id(11) is ctt.get_codec("adaptive_o1")
    head = ByteWriter().u8(1).u8(11).getvalue()
    assert ctt.decompress(head + tref.o1_encode(b"stage"), codec="pipeline",
                          **CPU) == b"stage"
