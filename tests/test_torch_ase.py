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
