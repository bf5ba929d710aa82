"""CT-ASE1 (ase) in the port, on the CPU (the plain versions of kernels S
and T), with exact equality throughout (integer codec: tolerance 0).

The same seeded inputs go through the JAX package's
ase_ops.ase_encode_jax / ase_decode_jax (XLA scans on the CPU, no Pallas
kernel) and through the port's `device="cpu"`: the containers must be
byte-identical, equal to the oracle (the port's copy of
reference/ase_ref.py), and decode on both sides."""

import numpy as np
import pytest
import torch

from conftest import corpus_file, std_cases

import cpprcoder_tpu_torch as ctt
from cpprcoder_tpu.codecs.pipeline import pipeline_decode, pipeline_encode
from cpprcoder_tpu.ops import ase_ops as jops
from cpprcoder_tpu.reference import ase_ref as jref
from cpprcoder_tpu_torch.ops import ase_kernels, ase_ops, layout
from cpprcoder_tpu_torch.reference import ase_ref as tref

CPU = {"device": "cpu"}


def _seeded(n, seed, alphabet=256):
    rng = np.random.default_rng(seed)
    return bytes(rng.integers(0, alphabet, n, dtype=np.uint8))


def _cases():
    cases = {f"std {i}": d for i, d in enumerate(std_cases())}
    cases["grammar.lsp"] = corpus_file("grammar.lsp")
    cases["seeded skewed"] = bytes(
        np.minimum(np.random.default_rng(5).geometric(0.08, 3000), 255)
        .astype(np.uint8))
    return cases


CASES = _cases()


@pytest.mark.parametrize("lanes", [1, 2, 8, 64])
@pytest.mark.parametrize("case", list(CASES))
def test_ase_matches_jax_and_oracle(case, lanes):
    data = CASES[case]
    blob = ctt.compress(data, codec="ase", lanes=lanes, **CPU)
    assert blob == jops.ase_encode_jax(data, lanes=lanes)
    assert blob == tref.ase_encode(data, lanes=lanes)
    assert ctt.decompress(blob, codec="ase", **CPU) == data
    assert jops.ase_decode_jax(blob) == data


def _table_edge_hits(rounds):
    """64 distinct symbols, then hits at table indices 15, 16, 31, 32, 47,
    48, 0 and 63 in turn: either side of kernel T's quad boundaries."""
    table = list(range(64))
    out = list(table)
    for _ in range(rounds):
        for idx in (15, 16, 31, 32, 47, 48, 0, 63):
            s = table.pop(idx)
            table.append(s)
            out.append(s)
    return bytes(out)


# the hard cases of chip_smoke.py's phase 3, at a few thousand steps; the
# last three for kernel T's quads: lanes whose first words sit at offsets
# 0, 2, 1 and 3 mod 4, hits either side of the quad's boundaries, and a
# full table evicting every step at K = 2
HARD = {
    "runs (every hit at d = 0)": (b"\x33" * 1500 + b"\x44" * 1500, 2),
    "all 256 values cycled (a full table evicting every step)":
        (bytes(range(256)) * 12, 1),
    "64 distinct symbols": (_seeded(4000, 7, 64), 1),
    "65 distinct symbols": (_seeded(4000, 8, 65), 1),
    "n not a multiple of K": (_seeded(8 * 301 + 5, 9, 40), 8),
    "K = 1": (corpus_file("xargs.1")[:3000], 1),
    "default lanes": (corpus_file("fields.c"), None),
    "first words at each offset mod 4": (_seeded(4 * 500 + 1, 1, 70), 4),
    "hits at the quad's edges": (_table_edge_hits(300), 1),
    "full table evicting, K = 2": (bytes(range(256)) * 12, 2),
}


@pytest.mark.parametrize("case", list(HARD))
def test_ase_hard_cases_match_the_oracle(case):
    data, lanes = HARD[case]
    blob = ctt.compress(data, codec="ase", lanes=lanes, **CPU)
    assert blob == tref.ase_encode(data, lanes=lanes)
    assert ctt.decompress(blob, codec="ase", **CPU) == data
    assert tref.ase_decode(blob) == data


@pytest.mark.parametrize("case", ["first words at each offset mod 4",
                                  "hits at the quad's edges",
                                  "full table evicting, K = 2"])
def test_quad_cases_match_jax(case):
    data, lanes = HARD[case]
    blob = ctt.compress(data, codec="ase", lanes=lanes, **CPU)
    assert blob == jops.ase_encode_jax(data, lanes=lanes)
    assert jops.ase_decode_jax(blob) == data


def test_first_words_sit_at_each_offset_mod_4():
    data, k = HARD["first words at each offset mod 4"]
    bits = np.frombuffer(tref.ase_encode(data, lanes=k)[5:5 + 4 * k],
                         np.uint32).astype(np.int64)
    counts = (bits + 15) // 16
    assert sorted(((np.cumsum(counts) - counts) % 4).tolist()) == [0, 1, 2, 3]


def test_each_side_decodes_the_others_containers():
    """The port decodes the JAX package's and the oracles' containers, and
    the JAX package and both oracles decode the port's."""
    for data, lanes in ((corpus_file("grammar.lsp"), 4),
                        (_seeded(2000, 3, 70), 2), (b"z", 8)):
        mine = ctt.compress(data, codec="ase", lanes=lanes, **CPU)
        for blob in (jops.ase_encode_jax(data, lanes=lanes),
                     jref.ase_encode(data, lanes=lanes),
                     tref.ase_encode(data, lanes=lanes)):
            assert ctt.decompress(blob, codec="ase", **CPU) == data
        for dec in (jops.ase_decode_jax, jref.ase_decode, tref.ase_decode):
            assert dec(mine) == data


def test_backends_agree():
    data = corpus_file("xargs.1")[:1500]
    blob = ctt.compress(data, codec="ase", **CPU)
    assert blob == ctt.compress(data, codec="ase", backend="torch")
    assert blob == ctt.compress(data, codec="ase", backend="ref")
    assert ctt.decompress(blob, codec="ase", backend="ref") == data
    assert ctt.get_codec_by_id(7) is ctt.get_codec("ase")


def test_lane_counts_and_empty_input():
    """lanes 0 and None pick pick_lanes(n); a lane count that is not a
    power of two, or above 65,536, raises ValueError; n = 0 writes the
    oracle's 5-byte container."""
    data = b"lane policy " * 100
    assert ctt.compress(data, codec="ase", lanes=0, **CPU) \
        == ctt.compress(data, codec="ase", **CPU) == tref.ase_encode(data)
    for lanes in (3, 6, 100):
        with pytest.raises(ValueError, match="power of two"):
            ctt.compress(data, codec="ase", lanes=lanes, **CPU)
    x2d = torch.zeros((1, 1 << 17), dtype=torch.uint8)
    with pytest.raises(ValueError, match="lanes"):
        ase_kernels.encode_words(x2d, torch.ones(1 << 17, dtype=torch.int32))
    for lanes in (None, 1, 64):
        blob = ctt.compress(b"", codec="ase", lanes=lanes, **CPU)
        assert blob == tref.ase_encode(b"", lanes=lanes) \
            == jops.ase_encode_jax(b"", lanes=lanes)
        assert ctt.decompress(blob, codec="ase", **CPU) == b""


def test_plain_versions_keep_the_kernels_contract():
    """encode_words_plain's payload is the lanes' words lane after lane,
    zero past them, words_cap(stride) a lane; decode_symbols_plain reads
    zeros past a lane's end and never past the payload."""
    data = _seeded(4 * 250 + 3, 11, 90)
    n, k = len(data), 4
    stride = -(-n // k)
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    lens = layout.lane_lengths_interleaved(n, k, stride, "cpu")
    payload, bits = ase_kernels.encode_words(
        layout.pad2d_interleaved(x, k, stride), lens)
    assert payload.dtype == torch.int16
    assert payload.numel() == k * ase_ops.words_cap(stride)
    counts = (bits.to(torch.int64) + 15) // 16
    p = int(counts.sum())
    assert not payload[p:].any()
    blob = tref.ase_encode(data, lanes=k)
    assert payload[:p].view(torch.uint8).numpy().tobytes() == blob[5 + 4 * k:]
    bases = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    out = ase_kernels.decode_symbols(payload[:p].clone(), bases,
                                     counts.to(torch.int32), lens, n, stride)
    assert out.numpy().tobytes() == data
    # counts that claim more words than the payload holds read zeros
    # there, never past the payload's end
    cut = payload[:p - 3].clone()
    zeros = torch.cat([cut, torch.zeros(3, dtype=torch.int16)])
    args = (bases, counts.to(torch.int32), lens, n, stride)
    assert torch.equal(ase_ops.decode_symbols_plain(cut, *args),
                       ase_ops.decode_symbols_plain(zeros, *args))


def test_pipeline_with_an_ase_stage_matches_jax():
    data = corpus_file("grammar.lsp")[:2000]
    stages = ["mtf", ("ase", {"lanes": 2})]
    blob = ctt.compress(data, codec="pipeline", stages=stages, **CPU)
    assert blob[:3] == bytes([2, 5, 7])
    assert blob == pipeline_encode(data, stages=stages)
    assert ctt.decompress(blob, codec="pipeline", **CPU) == data
    assert pipeline_decode(blob) == data


# ------------------------- kernel S's formulation: segments from the input
#
# The encoder's table is a function of the input alone, so kernel S codes
# a lane's segments side by side, each from its start table: the LRU
# composition of the segments before it (ase_ops.segment_states_plain),
# or, step by step, each code from the step's stack distance
# (ase_ops.stack_distance_plain). Both are held to the JAX package's scan
# and the oracle, and `_s_kernel_model` (passes 3 to 6 of csrc/ase.cu:
# newest-first tables, bit counts, the offsets and scan, each word written
# by the segment its first bit lies in) to the plain encoder. Change the model
# with the kernel.

def _interleave(lanes):
    """Per-lane byte sequences -> the interleaved input (lane i's step j at
    j*K + i), the lanes cut to the shortest plus one step for the first
    ones (lanes of steps - 1 steps when n is not a multiple of K)."""
    k = len(lanes)
    steps = min(len(s) for s in lanes)
    x = np.zeros((steps + 1, k), np.uint8)
    for i, s in enumerate(lanes):
        s = np.frombuffer(bytes(s[:steps + 1]), np.uint8)
        x[:len(s), i] = s
    n = steps * k + (k // 2 if k > 1 else 1)
    return x.reshape(-1)[:n].tobytes()


def _lane(kind, seed):
    """One lane's bytes of a kind (about 700 steps)."""
    rng = np.random.default_rng(seed)
    if kind == "63 and 64 distinct between occurrences":
        out = []
        for r in range(6):
            a, b = 200 + r % 40, 250 - r % 5
            out += [a] + list(range(63)) + [a] + [b] + list(range(64)) + [b]
        return bytes(out)
    if kind == "previous occurrence segments back":
        out = []
        for r in range(5):
            out += [7 + r] + list(rng.integers(0, 3, 130)) + [7 + r]
        return bytes(np.array(out, np.uint8))
    if kind == "one byte over many segments":
        return b"\x00" * 400 + bytes(rng.integers(0, 90, 300, dtype=np.uint8))
    if kind == "ptt5":
        return corpus_file("ptt5")[seed * 700:(seed + 1) * 700]
    if kind == "66 values (eviction at the edge)":
        return bytes(rng.integers(0, 66, 700, dtype=np.uint8))
    if kind == "text":
        return corpus_file("grammar.lsp")[seed * 700:(seed + 1) * 700]
    if kind == "zeros (a segment in one word)":
        return bytes(700)
    return bytes(range(256)) * 3          # a full table evicting every step


S_KINDS = ["63 and 64 distinct between occurrences",
           "previous occurrence segments back", "one byte over many segments",
           "ptt5", "66 values (eviction at the edge)", "text",
           "zeros (a segment in one word)", "all 256 values cycled"]


def _s_input(kind, k):
    data = _interleave([_lane(kind, i) for i in range(k)])
    n = len(data)
    stride = -(-n // k)
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    return (data, layout.pad2d_interleaved(x, k, stride),
            layout.lane_lengths_interleaved(n, k, stride, "cpu"))


_JAX_TABLES = {}


def _jax_tables(kind, k):
    """The table and size before every step: the JAX package's table update
    (`ase_ops._update`) run over the steps as `_encode_fn`'s scan runs it.
    -> (tables [stride, K, 64], sizes [stride, K]) numpy."""
    if (kind, k) not in _JAX_TABLES:
        import jax.numpy as jnp
        from jax import lax

        data, x2d, _ = _s_input(kind, k)
        n = len(data)

        def step(carry, xt):
            table, size, t_idx = carry
            active = (t_idx * k + jnp.arange(k)) < n
            sym = xt.astype(jnp.int32)
            found = (table == sym[:, None]) & (
                jnp.arange(64, dtype=jnp.int32)[None, :] < size[:, None])
            hit = found.any(axis=1)
            idx0 = jnp.argmax(found, axis=1).astype(jnp.int32)
            table2, size2 = jops._update(table, size, sym, hit, idx0)
            return ((jnp.where(active[:, None], table2, table),
                     jnp.where(active, size2, size), t_idx + 1),
                    (table, size))

        init = (jnp.zeros((k, 64), jnp.int32), jnp.zeros(k, jnp.int32), 0)
        _, (tables, sizes) = lax.scan(step, init, jnp.asarray(x2d.numpy()))
        _JAX_TABLES[(kind, k)] = (np.asarray(tables), np.asarray(sizes))
    return _JAX_TABLES[(kind, k)]


@pytest.mark.parametrize("seg", [1, 3, 64])
@pytest.mark.parametrize("lanes", [1, 2, 8])
@pytest.mark.parametrize("kind", S_KINDS)
def test_s_segment_start_tables_match_the_jax_scan(kind, lanes, seg):
    """Each segment's start table (the LRU composition of the segments
    before it) is the JAX scan's table at its first step: the same size
    and entries, zero past the size, and bits = ENTROPY[size]."""
    _, x2d, lens = _s_input(kind, lanes)
    tables, sizes, bits = ase_ops.segment_states_plain(x2d, lens, seg)
    jt, js = _jax_tables(kind, lanes)
    at = np.arange(tables.shape[0]) * seg
    assert np.array_equal(sizes.numpy(), js[at])
    slot = np.arange(64)[None, None, :]
    live = slot < js[at][:, :, None]
    assert np.array_equal(np.where(live, jt[at], 0), tables.numpy())
    assert np.array_equal(bits.numpy(), tref.ENTROPY[js[at]])


@pytest.mark.parametrize("lanes", [1, 2, 8])
@pytest.mark.parametrize("kind", S_KINDS)
def test_s_stack_distance_codes_match_jax_and_the_oracle(kind, lanes):
    """The words and bit counts built from each step's (p, D, N) equal the
    plain encoder's, the JAX package's and the oracle's."""
    data, x2d, lens = _s_input(kind, lanes)
    payload, bits = ase_ops.pack_words_plain(
        *ase_ops.stack_distance_plain(x2d, lens))
    want = ase_ops.encode_words_plain(x2d, lens)
    assert torch.equal(payload, want[0]) and torch.equal(bits, want[1])
    p = int(((bits.to(torch.int64) + 15) // 16).sum())
    blob = payload[:p].view(torch.uint8).numpy().tobytes()
    head = bits.numpy().astype("<u4").tobytes()
    for oracle in (jops.ase_encode_jax(data, lanes=lanes),
                   tref.ase_encode(data, lanes=lanes)):
        assert oracle[5:] == head + blob


def _mtf_code(tab, sym):
    """csrc/ase.cu's step on a newest-first table (a list, changed in
    place): -> (val, width)."""
    bits = int(tref.ENTROPY[len(tab)])
    if sym in tab:
        d = tab.index(sym)
        del tab[d]
        tab.insert(0, sym)
        return (d << 1) | 1, bits + 1
    tab.insert(0, sym)
    del tab[64:]
    return sym << 1, 9


def _s_kernel_model(x2d, lens, seg):
    """Kernel S's passes 3 to 6 over segment_states_plain's start tables:
    each segment's bit count, the lanes' offsets, then each word written by
    the segment its first bit lies in, coding on past the segment's end
    until that word is whole or the lane ends; zeros past the last lane's
    words. -> (payload int16, bits int32, words written twice)."""
    stride, k = x2d.shape
    tables, sizes, _ = ase_ops.segment_states_plain(x2d, lens, seg)
    x, lens = x2d.numpy(), lens.numpy()
    nseg = tables.shape[0]

    def start(s, i):
        return [int(v) for v in tables[s, i, :sizes[s, i]]][::-1]

    sbits = np.zeros((nseg, k), np.int64)
    for s in range(nseg):
        for i in range(k):
            tab = start(s, i)
            sbits[s, i] = sum(_mtf_code(tab, int(x[t, i]))[1] for t in
                              range(s * seg, min(s * seg + seg, lens[i])))
    soff = np.cumsum(sbits, axis=0) - sbits
    lane_bits = sbits.sum(axis=0)
    counts = (lane_bits + 15) // 16
    lbase = np.cumsum(counts) - counts
    payload = np.full(k * ase_ops.words_cap(stride), -1, np.int64)
    twice = 0
    for s in range(nseg):
        for i in range(k):
            lo = s * seg
            if lo >= min(lo + seg, lens[i]):
                continue
            b0 = int(lbase[i]) * 16 + int(soff[s, i])
            first, last = (b0 + 15) >> 4, (b0 + int(sbits[s, i]) - 1) >> 4
            if first > last:
                continue
            m, nb, acc, tab = b0 >> 4, b0 & 15, 0, start(s, i)
            for t in range(lo, lens[i]):
                val, width = _mtf_code(tab, int(x[t, i]))
                acc |= val << nb
                nb += width
                if nb >= 16:
                    if m >= first:
                        twice += payload[m] >= 0
                        payload[m] = acc & 0xFFFF
                    if m == last:
                        break
                    m, acc, nb = m + 1, acc >> 16, nb - 16
            else:
                if nb > 0 and m >= first:
                    twice += payload[m] >= 0
                    payload[m] = acc & 0xFFFF
    payload[int(counts.sum()):] = 0
    payload = np.where(payload >= 1 << 15, payload - (1 << 16), payload)
    return (torch.from_numpy(payload.astype(np.int16)),
            torch.from_numpy(lane_bits.astype(np.int32)), twice)


@pytest.mark.parametrize("seg", [1, 3, 64])
@pytest.mark.parametrize("lanes", [1, 2, 8])
@pytest.mark.parametrize("kind", S_KINDS)
def test_s_kernel_model_matches_the_plain_encoder(kind, lanes, seg):
    _, x2d, lens = _s_input(kind, lanes)
    payload, bits, twice = _s_kernel_model(x2d, lens, seg)
    want = ase_ops.encode_words_plain(x2d, lens)
    assert twice == 0
    assert torch.equal(bits, want[1]) and torch.equal(payload, want[0])


def test_s_segment_geometry_caps_the_scratch():
    """segment_steps keeps the segment count at most SEG_TARGET + K (so the
    scratch under 17.6 MB whatever n), at least SEG_MIN steps a segment
    where the stride allows, one segment a lane from K = SEG_TARGET on."""
    cap = 4 * (ase_ops.SEG_SCRATCH_WORDS * (ase_ops.SEG_TARGET + (1 << 16))
               + ase_ops.LANE_SCRATCH_WORDS)
    assert cap < 17_600_000
    for k in (1, 2, 8, 256, 2048, 1 << 15, 1 << 16):
        for stride in (1, 15, 16, 17, 503, 4023, 1 << 20, (1 << 31) // 9 // k):
            seg = ase_ops.segment_steps(k, stride)
            nseg = -(-stride // seg)
            assert 1 <= seg <= stride
            assert seg >= min(ase_ops.SEG_MIN, stride)
            assert k * nseg <= ase_ops.SEG_TARGET + k
            assert 4 * ase_ops.segment_scratch_words(k, stride, seg) <= cap
            if k >= ase_ops.SEG_TARGET:
                assert nseg == 1
    assert ase_ops.segment_steps(256, 4023) == 32
    assert ase_ops.segment_steps(2, 1861) == ase_ops.SEG_MIN
